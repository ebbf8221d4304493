"""Floating-point operations of Restormer's forward, from its layer list
(``perfbench/reference/restormer.py``): 2 per multiply-add of every
convolution, the depthwise ones included, and of both attention products
(``q_hat k_hat^T`` and ``A v``); the norms, softmax, GELU, gate, pixel
(un)shuffles and residual adds are left out (under 1% of the total)."""

from __future__ import annotations


def conv(h: int, w: int, cin: int, cout: int, k: int, groups: int = 1) -> int:
    """One SAME k x k convolution over an h x w plane."""
    return 2 * h * w * (cin // groups) * cout * k * k


def block(h: int, w: int, c: int, heads: int, factor: float) -> int:
    """One transformer block at width ``c``: MDTA (the qkv projection and
    its depthwise conv, the Gram map and ``A v``, each ``c * c_h`` a
    pixel, the output projection) and GDFN (project-in to ``2h``, its
    depthwise conv, project-out from ``h``), ``h = int(factor * c)``."""
    hidden, ch = int(c * factor), c // heads
    mdta = conv(h, w, c, 3 * c, 1) + conv(h, w, 3 * c, 3 * c, 3, 3 * c) + 2 * (2 * h * w * c * ch) + conv(h, w, c, c, 1)
    gdfn = conv(h, w, c, 2 * hidden, 1) + conv(h, w, 2 * hidden, 2 * hidden, 3, 2 * hidden) + conv(h, w, hidden, c, 1)
    return mdta + gdfn


def forward(cfg: dict, h: int, w: int) -> int:
    """One frame's forward at ``h x w``, padded up to multiples of 8 as the
    model runs it."""
    h, w = h + -h % 8, w + -w % 8
    d, nb, hd, f = cfg["dim"], cfg["num_blocks"], cfg["heads"], cfg["ffn_expansion_factor"]
    l1, l2, l3, l4 = (h, w), (h // 2, w // 2), (h // 4, w // 4), (h // 8, w // 8)
    total = conv(*l1, 3, d, 3)
    total += nb[0] * block(*l1, d, hd[0], f) + conv(*l1, d, d // 2, 3)
    total += nb[1] * block(*l2, 2 * d, hd[1], f) + conv(*l2, 2 * d, d, 3)
    total += nb[2] * block(*l3, 4 * d, hd[2], f) + conv(*l3, 4 * d, 2 * d, 3)
    total += nb[3] * block(*l4, 8 * d, hd[3], f)
    total += conv(*l4, 8 * d, 16 * d, 3) + conv(*l3, 8 * d, 4 * d, 1) + nb[2] * block(*l3, 4 * d, hd[2], f)
    total += conv(*l3, 4 * d, 8 * d, 3) + conv(*l2, 4 * d, 2 * d, 1) + nb[1] * block(*l2, 2 * d, hd[1], f)
    total += conv(*l2, 2 * d, 4 * d, 3)
    total += (nb[0] + cfg["num_refinement_blocks"]) * block(*l1, 2 * d, hd[0], f)
    return total + conv(*l1, 2 * d, 3, 3)
