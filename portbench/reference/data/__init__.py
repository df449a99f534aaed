# Frozen copy of reseek_tpu_torch/data/__init__.py (commit f533a72), the benchmark's plain
# reference: imports renamed, nothing else changed.
from portbench.reference.data.tables import Tables, get_tables

__all__ = ["Tables", "get_tables"]
