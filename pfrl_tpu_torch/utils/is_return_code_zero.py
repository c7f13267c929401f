"""Silent subprocess success check (counterpart of
``pfrl_tpu/utils/is_return_code_zero.py``; reference parity:
pfrl/utils/is_return_code_zero.py).

Used by prepare_output_dir to detect whether the CWD is inside a git
repository without spamming stderr.
"""

import subprocess


def is_return_code_zero(args) -> bool:
    """Return True iff running ``args`` exits with status 0 (output discarded)."""
    try:
        result = subprocess.run(
            args,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
            check=False,
        )
    except OSError:
        return False
    return result.returncode == 0
