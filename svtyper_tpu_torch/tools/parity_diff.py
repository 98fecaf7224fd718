"""Per-record parity diff for ``tools/reference_parity.py``.

The port's copy of ``scripts/parity_diff.py``, with the same rule:
GT exactly and GL/GQ/SQ and QUAL as their printed strings (SPEC.md §6
formats) between a reference svtyper output VCF and ours, plus the
order of the FORMAT header lines; a reference provenance line we do not
emit is reported and not counted. Exit code 0 on a pass, 1 otherwise.

    python -m svtyper_tpu_torch.tools.parity_diff reference.vcf ours.vcf label
"""

from __future__ import annotations

import sys


def load(path):
    recs = {}
    fmt_fields = None
    headers = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("##"):
                headers.append(line.rstrip("\n"))
                continue
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 10:
                continue
            key = (cols[0], cols[1], cols[2])
            fmt = cols[8].split(":")
            fmt_fields = fmt
            samples = [dict(zip(fmt, s.split(":"))) for s in cols[9:]]
            recs[key] = (cols[5], samples)
    return recs, fmt_fields, headers


def diff_headers(ref_h, ours_h, label):
    """Header parity (SPEC.md §8 checklist): FORMAT declarations must
    match in content AND order; any reference provenance line
    (##commandline-style) we do not emit is reported. Returns the
    number of FORMAT mismatches (provenance lines are informational)."""
    rf = [h for h in ref_h if h.startswith("##FORMAT")]
    of = [h for h in ours_h if h.startswith("##FORMAT")]
    fails = 0
    if rf != of:
        fails += 1
        print("%-16s header FORMAT mismatch:" % label)
        for h in rf:
            if h not in of:
                print("  reference-only: %s" % h)
        for h in of:
            if h not in rf:
                print("  ours-only:      %s" % h)
        if sorted(rf) == sorted(of):
            print("  (same lines, different ORDER)")
    prov = [h for h in ref_h
            if h.lower().startswith(("##commandline", "##command_line",
                                     "##cmdline", "##source"))]
    ours_prov = [h for h in ours_h
                 if h.lower().startswith(("##commandline", "##command_line",
                                          "##cmdline", "##source"))]
    for h in prov:
        if h.split("=", 1)[0] not in [o.split("=", 1)[0] for o in ours_prov]:
            print("%-16s note: reference emits %s — we emit no such "
                  "provenance line (SPEC.md §8 checklist item)"
                  % (label, h.split("=", 1)[0]))
    return fails


def main(argv=None) -> int:
    ref_path, ours_path, label = (sys.argv[1:] if argv is None else argv)[:3]
    ref, _, ref_h = load(ref_path)
    ours, _, ours_h = load(ours_path)
    header_fails = diff_headers(ref_h, ours_h, label)
    n = 0
    fails = {"GT": 0, "GL": 0, "GQ": 0, "SQ": 0, "QUAL": 0, "missing": 0}
    for key, (rq, rsamps) in ref.items():
        n += 1
        got = ours.get(key)
        if got is None:
            fails["missing"] += 1
            continue
        oq, osamps = got
        if rq != oq:
            fails["QUAL"] += 1
        for rs, os_ in zip(rsamps, osamps):
            if rs.get("GT") != os_.get("GT"):
                fails["GT"] += 1
            for f in ("GL", "GQ", "SQ"):
                if rs.get(f) != os_.get(f):
                    fails[f] += 1
    ok = not any(fails.values()) and header_fails == 0
    print(
        "%-16s %d records: %s"
        % (
            label,
            n,
            "PASS"
            if ok
            else " ".join("%s=%d" % kv for kv in fails.items() if kv[1]),
        ),
        flush=True,
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
