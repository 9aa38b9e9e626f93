"""The plain DCGAN: generator, discriminator, the non-saturating losses and
plain SGD, in float32 (TF32 off) from the HWIO weights the benchmark made.

Images are NHWC at the interfaces, as the program serves them; inside,
each layer is one ``F.conv_transpose2d`` or ``F.conv2d`` in NCHW.

- Generator: ``relu(z @ proj)`` reshaped to (B, h0, h0, C0), then per layer
  a transposed conv of stride s with 'SAME'-style padding (out = s · in:
  the zero-inserted input padded by (pl, ph), pl + ph = k + s - 2,
  ``pl = (k - s + 1) // 2``, correlated with the kernel), plus its bias;
  ReLU between layers, tanh after the last.
- Discriminator: the mirrored strided convs (pad k // 2 before, (k - 1) // 2
  after, no bias), each followed by leaky ReLU 0.2; the features flattened
  in NHWC order; a dense head to one logit.
- Losses: d = mean(softplus(-D(real)) + softplus(D(fake))), g =
  mean(softplus(-D(fake))), softplus(x) = log(1 + e^x).  A step takes the
  d-gradients and the g-gradients from the old params, then p - lr * g on
  both players.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from bench.reference.common import ieee_fp32, product


def deconv_padding(kernel: int, stride: int) -> tuple[int, int]:
    total = kernel + stride - 2
    low = max(0, (kernel - stride + 1) // 2)
    return low, total - low


def conv_transpose(x, k, stride: int, tf32: bool):
    """NCHW ``x``, HWIO ``k``: the zero-inserted input padded by (pl, ph)
    and correlated with ``k``, as ``F.conv_transpose2d`` of the flipped
    kernel (padding ``k - 1 - pl``, ``output_padding`` ph - pl)."""
    r = k.shape[0]
    low, high = deconv_padding(r, stride)
    w = k.flip(0, 1).permute(2, 3, 0, 1)
    return product(F.conv_transpose2d, x, w, tf32, stride=stride,
                   padding=r - 1 - low, output_padding=high - low)


def conv(x, k, stride: int, tf32: bool, dilation: int = 1):
    """NCHW ``x``, HWIO ``k``: the strided (dilated) correlation padded by
    ``dilation * (k // 2)`` before and ``dilation * ((k - 1) // 2)`` after,
    the program's 'SAME' sites."""
    r = k.shape[0]
    low = dilation * (r // 2)
    high = dilation * ((r - 1) // 2)
    if low != high:
        x = F.pad(x, (low, high, low, high))
        low = 0
    return product(F.conv2d, x, k.permute(3, 2, 0, 1), tf32, stride=stride,
                   padding=low, dilation=dilation)


def generator(w: dict, z: torch.Tensor, cfg: dict, tf32=False):
    """Latents (B, z_dim) -> images (B, H, W, 3) in [-1, 1]."""
    layers = cfg["layers"]
    h0, c0 = layers[0][0], layers[0][1]
    with ieee_fp32():
        x = torch.relu(product(torch.matmul, z, w["proj"], tf32))
        x = x.reshape(z.shape[0], h0, h0, c0).permute(0, 3, 1, 2)
        for i, (_, _, _, _, stride) in enumerate(layers):
            x = conv_transpose(x, w[f"dc{i}"], stride, tf32)
            x = x + w[f"b{i}"].reshape(1, -1, 1, 1)
            x = torch.tanh(x) if i == len(layers) - 1 else torch.relu(x)
    return x.permute(0, 2, 3, 1)


def discriminator(w: dict, img: torch.Tensor, cfg: dict, tf32=False):
    """Images (B, H, W, 3) -> logits (B, 1)."""
    layers = cfg["layers"]
    with ieee_fp32():
        x = img.permute(0, 3, 1, 2)
        for i, (_, _, _, _, stride) in enumerate(reversed(layers)):
            x = F.leaky_relu(conv(x, w[f"c{i}"], stride, tf32), 0.2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return product(torch.matmul, x, w["head"], tf32)


def softplus(x):
    return torch.logaddexp(x, x.new_zeros(()))


def batch_at(seed: int, step: int, batch: int, z_dim: int, hw: int):
    """Step ``step``'s batch: ``z`` (B, z_dim) standard normal and ``real``
    (B, hw, hw, 3) uniform in [-1, 1], from ``default_rng((seed, step))``
    in that order."""
    rng = np.random.default_rng((seed, step))
    z = rng.standard_normal((batch, z_dim), dtype=np.float32)
    real = rng.uniform(-1, 1, (batch, hw, hw, 3)).astype(np.float32)
    return z, real


def is_generator_leaf(name: str) -> bool:
    return name == "proj" or name.startswith(("dc", "b"))


def sgd_step(w: dict, z, real, cfg: dict, lr: float, tf32=False):
    """One step of both players from the old params: (new weights, g_loss,
    d_loss).  The backward's products run with TF32 off too."""
    with ieee_fp32():
        return _sgd_step(w, z, real, cfg, lr, tf32)


def _sgd_step(w, z, real, cfg, lr, tf32):
    gw = {k: v.detach() for k, v in w.items() if is_generator_leaf(k)}
    dw = {k: v.detach() for k, v in w.items() if not is_generator_leaf(k)}
    # d-pass: the generator's output is a constant
    dl = {k: v.clone().requires_grad_() for k, v in dw.items()}
    fake = generator(gw, z, cfg, tf32).detach()
    d_loss = (softplus(-discriminator(dl, real, cfg, tf32))
              + softplus(discriminator(dl, fake, cfg, tf32))).mean()
    d_grad = torch.autograd.grad(d_loss, list(dl.values()))
    # g-pass: the discriminator's params are constants
    gl = {k: v.clone().requires_grad_() for k, v in gw.items()}
    g_loss = softplus(-discriminator(dw, generator(gl, z, cfg, tf32), cfg,
                                     tf32)).mean()
    g_grad = torch.autograd.grad(g_loss, list(gl.values()))
    new = {}
    with torch.no_grad():
        for (k, v), g in zip(gw.items(), g_grad):
            new[k] = v - lr * g
        for (k, v), g in zip(dw.items(), d_grad):
            new[k] = v - lr * g
    return new, float(g_loss.detach()), float(d_loss.detach())
