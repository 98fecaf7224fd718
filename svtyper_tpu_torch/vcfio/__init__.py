from svtyper_tpu_torch.vcfio.model import Genotype, Variant, Vcf  # noqa: F401
from svtyper_tpu_torch.vcfio.reader import read_vcf_lines  # noqa: F401
