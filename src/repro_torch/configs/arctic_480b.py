"""--arch arctic-480b (exact published config; see lm_archs.py)."""
from repro_torch.configs.lm_archs import ARCTIC as CONFIG  # noqa: F401
from repro_torch.configs.registry import get

BUNDLE = get("arctic-480b")
SHAPES = {s.name: s for s in BUNDLE.shapes}
smoke = BUNDLE.smoke
