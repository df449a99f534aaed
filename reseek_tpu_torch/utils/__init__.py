from reseek_tpu_torch.utils.logger import (Logger, get_logger, open_log,
                                     secs_to_hhmmss)

__all__ = ["Logger", "get_logger", "open_log", "secs_to_hhmmss"]
