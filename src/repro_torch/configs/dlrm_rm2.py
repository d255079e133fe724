"""--arch dlrm-rm2 (exact published config; see recsys_archs.py)."""
from repro_torch.configs.recsys_archs import DLRM_RM2 as CONFIG  # noqa: F401
from repro_torch.configs.registry import get

BUNDLE = get("dlrm-rm2")
SHAPES = {s.name: s for s in BUNDLE.shapes}
smoke = BUNDLE.smoke
