from .misc import (cpu_stats, lr_for_epoch, ramp_scheduling_function,
                   save_logs, set_seed, show_logs, untensor, update_logs)

__all__ = ["cpu_stats", "lr_for_epoch", "ramp_scheduling_function",
           "save_logs", "set_seed", "show_logs", "untensor", "update_logs"]
