"""Interactive yes/no prompt (counterpart of ``pfrl_tpu/utils/ask_yes_no.py``;
reference parity: pfrl/utils/ask_yes_no.py).

Used by the pretrained-model downloader before fetching archives.
"""


def ask_yes_no(question: str) -> bool:
    """Ask ``question`` on stdin until the user answers yes or no."""
    while True:
        try:
            answer = input(f"{question} (y/n): ").strip().lower()
        except EOFError:
            return False
        if answer in ("y", "yes"):
            return True
        if answer in ("n", "no"):
            return False
