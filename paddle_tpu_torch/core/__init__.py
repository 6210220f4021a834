from .place import resolve_device
from .anomaly import any_not_finite_host, rows_not_finite

__all__ = ["resolve_device", "rows_not_finite", "any_not_finite_host"]
