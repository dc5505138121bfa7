"""Re-price saved dry-run records on another hardware profile, without
rerunning the dry-run: each record carries its counted terms (FLOPs,
bytes, collective bytes a chip). A profile without link bandwidths of
its own (the H100's in ``core.hardware``) is priced with the links kept
in ``launch.analysis`` (``links_for``), as the dry-run prices it.

    PYTHONPATH=src python -m repro_torch.launch.reanalyze \\
        --records results/dryrun_16x16.jsonl --profile tpu_v5e
"""
import argparse
import json

from repro_torch.core.hardware import get_profile
from repro_torch.launch import analysis


def reprice(recs, profile):
    """The records with every ``ok`` one's roofline re-priced at
    ``analysis.links_for(profile)``; returns (records, number updated)."""
    links = analysis.links_for(profile)
    n = 0
    for rec in recs:
        if rec.get("ok"):
            rl = analysis.from_row(rec["roofline"], rec["chips"], profile,
                                   links)
            rec["roofline"] = dict(rec["roofline"], **rl.row())
            n += 1
    return recs, n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--records", required=True)
    ap.add_argument("--profile", default="h100_sxm",
                    help="a core.hardware profile name")
    ap.add_argument("--out", default=None, help="default: in place")
    args = ap.parse_args()

    recs = []
    with open(args.records) as f:
        for line in f:
            try:
                recs.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    recs, n = reprice(recs, get_profile(args.profile))
    out_path = args.out or args.records
    with open(out_path, "w") as f:
        for rec in recs:
            f.write(json.dumps(rec) + "\n")
    print(f"updated {n}/{len(recs)} records -> {out_path} "
          f"({args.profile})")


if __name__ == "__main__":
    main()
