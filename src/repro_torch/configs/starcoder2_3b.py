"""--arch starcoder2-3b (exact published config; see lm_archs.py)."""
from repro_torch.configs.lm_archs import STARCODER2_3B as CONFIG  # noqa: F401
from repro_torch.configs.registry import get

BUNDLE = get("starcoder2-3b")
SHAPES = {s.name: s for s in BUNDLE.shapes}
smoke = BUNDLE.smoke
