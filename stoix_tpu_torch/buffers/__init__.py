"""On-device replay buffers (counterpart of stoix_tpu/buffers)."""

from stoix_tpu_torch.buffers.buffers import (
    ItemBuffer,
    ItemBufferSample,
    ItemBufferState,
    make_item_buffer,
)

__all__ = ["ItemBuffer", "ItemBufferSample", "ItemBufferState", "make_item_buffer"]
