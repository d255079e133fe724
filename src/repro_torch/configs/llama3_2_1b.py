"""--arch llama3.2-1b (exact published config; see lm_archs.py)."""
from repro_torch.configs.lm_archs import LLAMA32_1B as CONFIG  # noqa: F401
from repro_torch.configs.registry import get

BUNDLE = get("llama3.2-1b")
SHAPES = {s.name: s for s in BUNDLE.shapes}
smoke = BUNDLE.smoke
