"""PyTorch/CUDA port of the DCT autoencoder tokenizer, for NVIDIA Hopper.

Mirrors the module tree of the JAX package (ops/, patches/, models/,
kernels/, train/, tools/, pipeline.py).  The kernels of the serving path
(packed attention forward, fused IPT+DCT+patchify, fused IDCT+RGB) and of
training (the attention backward: dq, and dk/dv) are CUDA C++ under csrc/,
built with nvcc at first use; the same three attention kernels have the
causal mode that the autoregressive token model (models/ar.py,
tools/train_ar_example.py) trains through.  Entry points run on the card
unless given device="cpu".

The DCT products must run in true fp32, so importing the package turns
TF32 off for matmuls and cuDNN.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .models.config import DCTAutoencoderConfig, TransformerConfig  # noqa: E402
from .models.autoencoder import DCTAutoencoder  # noqa: E402
from .models.factory import get_model_and_processor  # noqa: E402
from .patches.container import DCTPatches  # noqa: E402
from .patches.extractor import DCTAutoencoderFeatureExtractor  # noqa: E402
from .pipeline import DCTPipeline  # noqa: E402

__all__ = [
    "DCTAutoencoder",
    "DCTAutoencoderConfig",
    "DCTAutoencoderFeatureExtractor",
    "DCTPatches",
    "DCTPipeline",
    "TransformerConfig",
    "get_model_and_processor",
]
