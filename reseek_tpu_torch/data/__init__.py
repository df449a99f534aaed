from reseek_tpu_torch.data.tables import Tables, get_tables

__all__ = ["Tables", "get_tables"]
