"""The device rule of the port: entry points run on the card unless the
caller asks for the CPU, and never fall back from one to the other."""

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` (default ``cuda``) as a ``torch.device``.

    Raises when CUDA is asked for and no card is present. On CUDA, TF32 is
    turned off for matmuls and cuDNN so f32 products stay full f32: the
    dense-index distances keep the reference's numpy-exact contract."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was asked for but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
