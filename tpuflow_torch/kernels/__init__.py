"""Hand-written CUDA kernels of the port, each beside its plain version.

``KERNELS`` lists every wrapper with its launch counter, for runs that must
show that a path went through the kernels.
"""

from tpuflow_torch.kernels.lstm import lstm_scan, lstm_scan_reference

KERNELS = {"lstm_fwd": lstm_scan}

__all__ = ["KERNELS", "lstm_scan", "lstm_scan_reference"]
