"""Model FLOPs of a configuration, counted from its shapes.

The Nature network's forward at one frame is ``2 * MACs`` of its
convolutions, its dense layer and its head: 18,692,096 FLOP at 84x84x4
frames and 6 actions (the arithmetic of the JAX package's ``bench.py``,
counted here again). A transition costs one acting forward, and its share of
the updates: an update of ``B`` rows per ``U`` transitions is an online
forward, a backward at twice the forward and a target forward, four
forward-equivalents per row, and a fifth under the Double-DQN target (the
online network's forward at the next frame picks the action), so
``1 + 4 * B / U`` or ``1 + 5 * B / U`` forwards per transition.
"""


def forward_flops(cfg: dict) -> int:
    build, net = cfg["build"], cfg["network"]
    h, w, c = build["frame_shape"]
    macs = 0
    for features, k, s in net["convs"]:
        h, w = (h - k) // s + 1, (w - k) // s + 1
        macs += h * w * features * k * k * c
        c = features
    macs += h * w * c * net["hidden"] + net["hidden"] * build["n_actions"]
    return 2 * macs


def forwards_per_row(cfg: dict) -> int:
    return 5 if cfg["build"].get("double", False) else 4


def flops_per_transition(cfg: dict, traffic: dict) -> float:
    return forward_flops(cfg) * (1 + forwards_per_row(cfg) * traffic["minibatch_size"] / traffic["update_interval"])
