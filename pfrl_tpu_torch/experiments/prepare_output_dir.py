"""Experiment output directory with reproducibility capture (counterpart of
``pfrl_tpu/experiments/prepare_output_dir.py``).

Reference parity: pfrl/experiments/prepare_output_dir.py:14-162 — records
argv, environ, and git head/status/diff so results are reproducible.
"""

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
from typing import Optional

from pfrl_tpu_torch.utils.is_return_code_zero import is_return_code_zero


def generate_exp_id(prefix: Optional[str] = None, argv=None) -> str:
    argv = sys.argv if argv is None else argv
    now = datetime.datetime.now().strftime("%Y%m%dT%H%M%S.%f")
    base = f"{prefix}_{now}" if prefix else now
    return base


def _run_git(basedir, args):
    try:
        return subprocess.check_output(
            ["git"] + args, cwd=basedir, stderr=subprocess.DEVNULL
        )
    except Exception:
        return None


def prepare_output_dir(
    args=None,
    basedir: Optional[str] = None,
    exp_id: Optional[str] = None,
    argv=None,
    time_format: str = "%Y%m%dT%H%M%S.%f",
    make_backup: bool = False,
) -> str:
    """Create an output dir and dump args / command / environ / git state."""
    if exp_id is None:
        exp_id = datetime.datetime.now().strftime(time_format)
    if basedir is None:
        basedir = tempfile.mkdtemp()
    outdir = os.path.join(basedir, exp_id)
    os.makedirs(outdir, exist_ok=True)

    if args is not None:
        if isinstance(args, argparse.Namespace):
            args = vars(args)
        with open(os.path.join(outdir, "args.txt"), "w") as f:
            json.dump({k: str(v) for k, v in args.items()}, f, indent=2)

    with open(os.path.join(outdir, "command.txt"), "w") as f:
        f.write(" ".join(argv if argv is not None else sys.argv))

    with open(os.path.join(outdir, "environ.txt"), "w") as f:
        json.dump(dict(os.environ), f, indent=2)

    if not is_return_code_zero(["git", "rev-parse"]):
        return outdir  # not inside a git repository: nothing more to record
    for name, git_args in [
        ("git-head.txt", ["rev-parse", "HEAD"]),
        ("git-status.txt", ["status"]),
        ("git-log.txt", ["log", "-5"]),
        ("git-diff.txt", ["diff", "HEAD"]),
    ]:
        out = _run_git(os.getcwd(), git_args)
        if out is not None:
            with open(os.path.join(outdir, name), "wb") as f:
                f.write(out)
    return outdir
