"""--arch phi3.5-moe-42b-a6.6b (exact published config; see lm_archs.py)."""
from repro_torch.configs.lm_archs import PHI35_MOE as CONFIG  # noqa: F401
from repro_torch.configs.registry import get

BUNDLE = get("phi3.5-moe-42b-a6.6b")
SHAPES = {s.name: s for s in BUNDLE.shapes}
smoke = BUNDLE.smoke
