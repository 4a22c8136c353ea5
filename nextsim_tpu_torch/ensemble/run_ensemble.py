"""Ensemble run driver (the counterpart of
nextsim_tpu/ensemble/run_ensemble.py).

The analog of the reference's ensemble run scripts (reference:
scripts/ensemble/run_ensemble.sh, modules/enkf/run_ensemble_in_docker.sh):
run N members of the same configuration with member-specific perturbed
forcing (statevector.ensemble_member = 1..N; member 0 is the unperturbed
control), each writing to its own output directory ``mem_<k>/``. The
members run one after the other in this process; ``--member`` runs one, so
that separate processes can each take a member.

Usage:
    python -m nextsim_tpu_torch.ensemble.run_ensemble [--device cuda|cpu] \\
        --config-files X.cfg --num-members 4 [--control] [opt=value ...]

``--device`` is ``cuda`` by default; the CPU is used only when asked for.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List


def run_member(cfg_files: List[str], overrides: dict, member: int, base_out: str, device="cuda"):
    from nextsim_tpu_torch.config import Config
    from nextsim_tpu_torch.model.simulator import Simulator

    member_overrides = dict(overrides)
    member_overrides["statevector.ensemble_member"] = member
    member_overrides["output.exporter_path"] = os.path.join(base_out, f"mem_{member}")
    cfg = Config.from_files(*cfg_files, overrides=member_overrides)
    sim = Simulator(cfg, device=device)
    sim.run()
    return sim


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="nextsim_tpu_torch.ensemble.run_ensemble")
    parser.add_argument("--config-files", action="append", default=[])
    parser.add_argument("--num-members", type=int, default=4)
    parser.add_argument("--control", action="store_true",
                        help="also run the unperturbed member 0")
    parser.add_argument("--member", type=int, default=None,
                        help="run only this member (one process a member)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; cpu runs on the host)")
    args, extra = parser.parse_known_args(argv)

    overrides = {}
    files = list(args.config_files)
    for ov in extra:
        if "=" in ov and not ov.endswith(".cfg"):
            k, _, v = ov.partition("=")
            overrides[k.lstrip("-")] = v
        else:
            files.append(ov)

    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"run_ensemble: --device {args.device} needs a CUDA device, and torch.cuda.is_available() "
              "is false; pass --device cpu to run on the CPU", file=sys.stderr)
        return 2

    from nextsim_tpu_torch.config import Config

    base_cfg = Config.from_files(*files, overrides=overrides)
    base_out = base_cfg["output.exporter_path"]

    members = (
        [args.member]
        if args.member is not None
        else ([0] if args.control else []) + list(range(1, args.num_members + 1))
    )
    for m in members:
        print(f"=== ensemble member {m} ===", file=sys.stderr)
        run_member(files, overrides, m, base_out, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
