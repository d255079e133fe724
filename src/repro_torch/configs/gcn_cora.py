"""--arch gcn-cora (exact published config; see gnn_archs.py)."""
from repro_torch.configs.gnn_archs import GCN_CORA as CONFIG  # noqa: F401
from repro_torch.configs.registry import get

BUNDLE = get("gcn-cora")
SHAPES = {s.name: s for s in BUNDLE.shapes}
smoke = BUNDLE.smoke
