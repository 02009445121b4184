"""Public election verification CLI (counterpart of
node_fhe_accelerate_tpu/cli.py, whose console script is ``nfa-verify``):
load an exported VerificationPackage JSON, re-verify every proof and the
audit chain, print a human summary with live progress, and optionally
write JSON/HTML reports.

Usage:
    python -m node_fhe_accelerate_tpu_torch.cli verify package.json \
        [--json report.json] [--html report.html] [--quiet] [--device D]
    python -m node_fhe_accelerate_tpu_torch.cli export-demo demo.json \
        [--device D]

It runs on the card unless ``--device cpu`` asks for the CPU.
"""
from __future__ import annotations

import argparse
import sys


def _progress(i: int, total: int, stage: str):
    if total:
        pct = 100 * i // total
        sys.stderr.write(f"\r[{pct:3d}%] {stage} ({i}/{total})")
        if i == total:
            sys.stderr.write("\n")
        sys.stderr.flush()


def cmd_verify(args) -> int:
    from .api.verify import VerificationPackage, PublicVerifier

    with open(args.package) as f:
        raw = f.read()
    pkg = VerificationPackage.from_json(raw, device=args.device)
    verifier = PublicVerifier(progress=None if args.quiet else _progress,
                              device=args.device)
    res = verifier.verify_all(pkg)

    if args.json:
        with open(args.json, "w") as f:
            f.write(PublicVerifier.json_report(pkg, res))
    if args.html:
        with open(args.html, "w") as f:
            f.write(PublicVerifier.html_report(pkg, res))

    status = "VALID" if res.valid else "INVALID"
    print(f"election {pkg.election_id}: {status}")
    print(f"  ballots:     {res.ballots_valid}/{res.ballots_checked} valid")
    print(f"  audit chain: {'ok' if res.audit_valid else 'BROKEN'}")
    print(f"  nullifiers:  "
          f"{'unique' if res.nullifiers_unique else 'DUPLICATED'}")
    print(f"  tally:       "
          f"{'consistent' if res.tally_consistent else 'INCONSISTENT'}")
    for fmsg in res.failures:
        print(f"  failure: {fmsg}")
    print(f"  elapsed:     {res.elapsed_s:.2f}s")
    return 0 if res.valid else 1


def cmd_export_demo(args) -> int:
    """Run a tiny in-process election and export its package — a
    self-contained way to exercise the verifier end-to-end."""
    from .api.voting import VotingSystem
    from .api.verify import VerificationPackage

    vs = VotingSystem("demo", 2, threshold=(2, 3), enable_zk=False,
                      device=args.device)
    for i in range(4):
        vs.register_voter(f"voter-{i}")
    vs.start_election()
    for i, v in enumerate([0, 1, 1, 0]):
        vs.submit_ballot(f"voter-{i}", v)
    vs.end_election()
    vs.decrypt_tally([1, 2])
    pkg = VerificationPackage.from_voting_system(vs)
    with open(args.out, "w") as f:
        f.write(pkg.to_json())
    print(f"wrote {args.out}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nfa-verify",
        description="Public election verification")
    sub = ap.add_subparsers(dest="cmd", required=True)

    v = sub.add_parser("verify", help="verify an exported package")
    v.add_argument("package", help="VerificationPackage JSON file")
    v.add_argument("--json", help="write JSON report to this path")
    v.add_argument("--html", help="write HTML report to this path")
    v.add_argument("--quiet", action="store_true",
                   help="suppress progress output")
    v.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    v.set_defaults(fn=cmd_verify)

    d = sub.add_parser("export-demo",
                       help="run a demo election and export its package")
    d.add_argument("out", help="output JSON path")
    d.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    d.set_defaults(fn=cmd_export_demo)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
