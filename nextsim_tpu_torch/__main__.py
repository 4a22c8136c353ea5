"""Command-line entry point (the counterpart of nextsim_tpu/__main__.py).

The reference ships one executable (reference: model/main.cpp:21-37;
model/run.sh:55: ``mpirun -np N nextsim.exec --config-files=X.cfg``). Here:

    python -m nextsim_tpu_torch [--device cuda|cpu] --config-files=X.cfg [section.option=value ...]

Multiple config files merge left-to-right; bare ``name=value`` arguments
override individual options (like the reference's CLI override of
program_options). A run log with the full resolved config and git hash is
written next to the outputs (reference: writeLogFile, fe.cpp:14371-14487).

``--device`` picks the torch device, ``cuda`` by default. Without a CUDA
device the run stops with an error; the CPU is used only when asked for.

A device mesh (``tpu.mesh_shape=DPYxDPX``) runs one process per block, as
the reference runs one MPI rank per partition (model/run.sh:55):

    torchrun --nproc-per-node 4 -m nextsim_tpu_torch [--device cpu] ... tpu.mesh_shape=2x2

or with RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT (or the JAX
package's JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID) set in
each process (parallel/distributed.py). Rank r takes ``cuda:{r % cards}``;
rank 0 writes the log and the outputs.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def write_log_file(sim) -> None:
    cfg = sim.cfg
    path = cfg["output.exporter_path"]
    os.makedirs(path, exist_ok=True)
    try:
        git_hash = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ).stdout.strip()
    except Exception:
        git_hash = "unknown"
    with open(os.path.join(path, "nextsim_tpu.log"), "w") as f:
        f.write(f"# nextsim_tpu_torch run log\n# git: {git_hash}\n")
        f.write(f"# argv: {' '.join(sys.argv)}\n# device: {sim.device}\n\n")
        f.write(cfg.dump())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="nextsim_tpu_torch",
        epilog="Remaining arguments: more .cfg files, or section.option=value "
               "overrides. --help-options lists every option.",
    )
    parser.add_argument("--config-file", action="append", default=[])
    parser.add_argument("--config-files", action="append", default=[])
    parser.add_argument(
        "--help-options", action="store_true",
        help="print every config option (type, default, allowed values) and exit",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default cuda; cpu runs on the host)",
    )
    args, extra = parser.parse_known_args(argv)

    from nextsim_tpu_torch.config import Config

    if args.help_options:
        # the analog of the reference's --help option dump (model/main.cpp:27-33)
        print(Config.describe_options())
        return 0

    files = list(args.config_file) + list(args.config_files)
    overrides = {}
    for ov in extra:
        # remaining args: either more config files or section.option=value
        if "=" in ov and not ov.endswith(".cfg"):
            k, _, v = ov.partition("=")
            overrides[k.lstrip("-")] = v
        else:
            files.append(ov)

    try:
        cfg = Config.from_files(*files, overrides=overrides)
    except (KeyError, ValueError, FileNotFoundError) as e:
        # config mistakes get a one-line message, not a traceback (the
        # reference prints program_options' error string; main.cpp:34-36)
        if isinstance(e, FileNotFoundError):
            msg = f"config file not found: {e.filename}"
        else:
            msg = e.args[0] if e.args else str(e)
        print(f"nextsim_tpu_torch: config error: {msg}", file=sys.stderr)
        return 2

    import torch

    try:
        device = torch.device(args.device)
    except RuntimeError as e:
        print(f"nextsim_tpu_torch: bad --device {args.device!r}: {e}", file=sys.stderr)
        return 2
    if device.type == "cuda" and not torch.cuda.is_available():
        print(
            f"nextsim_tpu_torch: --device {args.device} needs a CUDA device, and "
            "torch.cuda.is_available() is false; pass --device cpu to run on the CPU",
            file=sys.stderr,
        )
        return 2

    # ranks of a multi-device run (none named: one process)
    import torch.distributed as dist

    from nextsim_tpu_torch.model.simulator import Simulator
    from nextsim_tpu_torch.parallel.distributed import init_distributed, local_device
    from nextsim_tpu_torch.parallel.multihost import is_writer

    joined = not dist.is_initialized() and init_distributed(device)
    try:
        sim = Simulator(cfg, device=local_device(device))
        if is_writer():
            write_log_file(sim)
        sim.run()
    finally:
        if joined:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
