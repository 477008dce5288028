from repro_torch.kernels.mamba_scan.mamba_scan import (
    LAUNCHES, build, reset_launches, ssd_chunks, ssd_chunks_seq,
)
from repro_torch.kernels.mamba_scan.ops import ssd_scan
from repro_torch.kernels.mamba_scan.ref import (
    chunk_ref, ssd_chunks_plain, ssd_chunks_seq_plain,
)

__all__ = ["LAUNCHES", "build", "chunk_ref", "reset_launches", "ssd_chunks",
           "ssd_chunks_plain", "ssd_chunks_seq", "ssd_chunks_seq_plain",
           "ssd_scan"]
