"""Pretrained model zoo access (counterpart of
``pfrl_tpu/utils/pretrained_models.py``; reference parity:
pfrl/utils/pretrained_models.py).

The zoo resolves models from a local directory tree
(``PFRL_TPU_MODEL_ZOO`` or ``~/.pfrl_tpu/models``) laid out as
``<zoo>/<algo>/<env>/{best,final}/...``, the layout of the repository's
``zoo/``. ``download_model`` keeps the reference's signature and fetches
the archive over urllib only where the directory is missing; the
checkpoints it finds are the JAX package's (flax msgpack), which the port
reads with :mod:`pfrl_tpu_torch.utils.flax_msgpack` (see
:mod:`pfrl_tpu_torch.experiments.zoo`).
"""

import os
from typing import List, Tuple

MODEL_ZOO_URL_ROOT = "https://chainer-assets.preferred.jp/pfrl"


def get_model_zoo_root() -> str:
    return os.environ.get(
        "PFRL_TPU_MODEL_ZOO", os.path.expanduser("~/.pfrl_tpu/models")
    )


def download_model(
    alg: str, env: str, model_type: str = "best"
) -> Tuple[str, bool]:
    """Resolve (and if possible fetch) a pretrained model directory.

    Returns (path, exists). Mirrors pfrl/utils/pretrained_models.py:160's
    contract of returning a directory to pass to ``agent.load``.
    """
    local = os.path.join(get_model_zoo_root(), alg, env, model_type)
    if os.path.isdir(local):
        return local, True
    url = f"{MODEL_ZOO_URL_ROOT}/{alg}/{env}/{model_type}.zip"
    try:
        import io
        import urllib.request
        import zipfile

        with urllib.request.urlopen(url, timeout=30) as resp:
            data = resp.read()
        os.makedirs(local, exist_ok=True)
        with zipfile.ZipFile(io.BytesIO(data)) as zf:
            zf.extractall(local)
        return local, True
    except Exception:
        return local, False


def list_local_models() -> List[str]:
    root = get_model_zoo_root()
    found = []
    if not os.path.isdir(root):
        return found
    for alg in sorted(os.listdir(root)):
        for env in sorted(os.listdir(os.path.join(root, alg))):
            found.append(f"{alg}/{env}")
    return found
