from reseek_tpu_torch.io.cal import read_cal, write_cal
from reseek_tpu_torch.io.bca import BCAReader, BCAWriter, read_bca, write_bca
from reseek_tpu_torch.io.reader import read_chains, scan_structure_files

__all__ = [
    "read_cal", "write_cal",
    "BCAReader", "BCAWriter", "read_bca", "write_bca",
    "read_chains", "scan_structure_files",
]
