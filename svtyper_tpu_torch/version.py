__version__ = "0.1.0"

# Version of the reference tool whose behavior this framework reproduces
# (hall-lab/svtyper; see SURVEY.md §0 / SPEC.md provenance).
REFERENCE_VERSION = "0.7.1"
