from repro_torch.serve.engine import Request, ServeConfig, ServeEngine
from repro_torch.serve.lanes import LanePool

__all__ = ["LanePool", "Request", "ServeConfig", "ServeEngine"]
