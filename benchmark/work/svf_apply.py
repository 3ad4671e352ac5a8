"""Required work of one apply request: the velocity's resize, the
squarings' linear pulls (value), the cubic warp of the image, and the
label map's warp (read once, written once).  Kernel 1 (``warp``)
carries the pulls and the label map's warp; PyTorch the resize."""
from __future__ import annotations

from . import counts


def required(cfg, traffic):
    vol, coarse, o = cfg["vol_shape"], cfg["coarse_shape"], \
        cfg["interpolation"]
    b, f = counts.warp("value", (1, 1, 1), 1, 3, vol)
    return [("resize", *counts.resize(o, 3, coarse, vol), None),
            ("exp.value", cfg["steps"] * b, cfg["steps"] * f, "warp"),
            ("warp.value", *counts.warp("value", (o,) * 3, 1, 1, vol),
             "warp"),
            ("labels", *counts.label_pull(traffic["label_order"], vol),
             "warp")]
