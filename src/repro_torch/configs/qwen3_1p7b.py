"""--arch qwen3-1.7b (exact published config; see lm_archs.py)."""
from repro_torch.configs.lm_archs import QWEN3_1P7B as CONFIG  # noqa: F401
from repro_torch.configs.registry import get

BUNDLE = get("qwen3-1.7b")
SHAPES = {s.name: s for s in BUNDLE.shapes}
smoke = BUNDLE.smoke
