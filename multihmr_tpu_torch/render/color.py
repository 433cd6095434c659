"""Demo color palette (``multihmr_tpu/render/color.py``; reference
utils/color.py:12-21): 10 fixed colors then 200 deterministic pseudo-random
pastels."""

import numpy as np

_FIXED = [
    (0.65, 0.74, 0.86),
    (0.64, 0.85, 0.66),
    (0.90, 0.65, 0.63),
    (0.85, 0.78, 0.55),
    (0.72, 0.62, 0.82),
    (0.58, 0.80, 0.82),
    (0.88, 0.72, 0.85),
    (0.77, 0.85, 0.58),
    (0.85, 0.61, 0.73),
    (0.60, 0.70, 0.85),
]
_rng = np.random.default_rng(1234)
_EXTRA = 0.45 + 0.5 * _rng.uniform(size=(200, 3))

demo_color = [tuple(c) for c in _FIXED] + [tuple(c) for c in _EXTRA]
