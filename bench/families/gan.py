"""The DCGAN family on the program: ``models/gan.py`` through its plans.

The weights are made here, on the device, from the seed: every HWIO
kernel, bias, the projection and the head from one ``torch.randn`` call
on a card-side ``torch.Generator``, scaled by the configuration's ``std``.
The program gets them packed through each site's own ``ConvPlan.pack``;
the reference gets the same HWIO tensors."""
from __future__ import annotations

import torch

from bench.work import Site


def _layers(cfg: dict):
    from repro_torch.models import gan
    return tuple(gan.DeconvLayer(*l) for l in cfg["layers"])


def program_config(cfg: dict):
    from repro_torch.models import gan
    return gan.GANConfig(cfg["name"], _layers(cfg), z_dim=cfg["z_dim"],
                         backend=cfg["backend"])


def weight_shapes(cfg: dict, train: bool) -> dict:
    """HWIO shapes by the program's parameter names: the generator's, and
    the discriminator's where ``train``."""
    layers = cfg["layers"]
    h0, c0 = layers[0][0], layers[0][1]
    shapes = {"proj": (cfg["z_dim"], h0 * h0 * c0)}
    for i, (_, c, n, k, _) in enumerate(layers):
        shapes[f"dc{i}"] = (k, k, c, n)
        shapes[f"b{i}"] = (n,)
    if train:
        for i, (_, c, n, k, _) in enumerate(reversed(layers)):
            shapes[f"c{i}"] = (k, k, n, c)
        shapes["head"] = (h0 * h0 * c0, 1)
    return shapes


def make_weights(cfg: dict, seed: int, device, train: bool) -> dict:
    """Every weight from one normal draw on ``device``: N(0, std²), the
    biases N(0, bias_std²)."""
    shapes = weight_shapes(cfg, train)
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape), part in zip(shapes.items(), flat.split(sizes)):
        std = cfg["bias_std"] if name.startswith("b") else cfg["std"]
        out[name] = (part * std).reshape(shape)
    return out


def pack(cfg: dict, weights: dict) -> tuple:
    """(program config, generator params, discriminator params or None):
    the kernels packed by the program's own plans."""
    from repro_torch.models import gan
    pcfg = program_config(cfg)
    gp = {k: v for k, v in weights.items()
          if k == "proj" or k.startswith("b")}
    for i, plan in enumerate(gan.generator_plans(pcfg)):
        gp[f"dc{i}"] = plan.pack(weights[f"dc{i}"])
    dp = None
    if "head" in weights:
        dp = {"head": weights["head"]}
        for i, plan in enumerate(gan.discriminator_plans(pcfg)):
            dp[f"c{i}"] = plan.pack(weights[f"c{i}"])
    return pcfg, gp, dp


def serving(cfg: dict, weights: dict):
    """(served forward: latents -> images NHWC, one request's payload)."""
    import numpy as np
    from repro_torch.models import gan
    pcfg, gp, _ = pack(cfg, weights)

    def fn(z):
        return gan.generator_apply(gp, z, pcfg)
    return fn, np.zeros((cfg["z_dim"],), np.float32)


def make_inputs(cfg: dict, gen: torch.Generator, n: int, device):
    """``n`` request payloads (latents) on ``device``."""
    return torch.randn((n, cfg["z_dim"]), generator=gen, device=device)


def served_by_reference(cfg: dict, weights: dict, x: torch.Tensor,
                        tf32: bool):
    """The images the reference serves (the control, in TF32)."""
    from bench.reference import gan as ref
    return ref.generator(weights, x, cfg, tf32)


def compare(cfg: dict, weights: dict, x: torch.Tensor, got: torch.Tensor):
    """``image_rel_err`` of each image: max |served - reference| over max
    |reference|."""
    from bench.reference import gan as ref
    want = ref.generator(weights, x, cfg, False).double()
    if got.shape != want.shape:
        return "image_rel_err", torch.full((x.shape[0],), float("inf"))
    diff = (got.double() - want).abs().flatten(1).amax(1)
    return "image_rel_err", (diff / want.abs().flatten(1).amax(1))


class Trainer:
    """The program's training state and step: ``train_gan.train_step`` on
    the packed params of both players, fed by ``GANPipeline.batch_at``
    (the batch made on the host, then copied to the device)."""

    def __init__(self, cfg: dict, weights: dict, seed: int, batch: int,
                 lr: float, device):
        from repro_torch.train.data import GANPipeline
        self.cfg, self.lr, self.device = cfg, lr, device
        self.pcfg, self.gp, self.dp = pack(cfg, weights)
        hw = cfg["layers"][-1][0] * cfg["layers"][-1][4]
        self.pipe = GANPipeline(self.pcfg, batch, image_hw=hw, seed=seed)

    def batch(self, step: int):
        b = self.pipe.batch_at(step)
        return (torch.from_numpy(b["z"]).to(self.device),
                torch.from_numpy(b["real"]).to(self.device))

    def step(self, z, real):
        """One step; returns (g_loss, d_loss) as floats (reading them waits
        for the device, as a trainer that logs its losses does)."""
        from repro_torch.train_gan import train_step
        self.gp, self.dp, gl, dl = train_step(self.gp, self.dp, z, real,
                                              self.pcfg, self.lr)
        return float(gl), float(dl)

    def params(self) -> dict:
        """Every leaf by name (superpacks as they are stored)."""
        return {**self.gp, **self.dp}


def reference_train(cfg: dict, weights: dict, seed: int, batch: int,
                    lr: float, steps: int, device, tf32: bool):
    """The reference's first ``steps`` steps from the HWIO weights on its
    own batches: (losses [(g, d)] a step, weights after each step)."""
    from bench.reference import gan as ref
    hw = cfg["layers"][-1][0] * cfg["layers"][-1][4]
    w, losses, after = dict(weights), [], []
    for s in range(steps):
        z, real = ref.batch_at(seed, s, batch, cfg["z_dim"], hw)
        w, gl, dl = ref.sgd_step(w, torch.from_numpy(z).to(device),
                                 torch.from_numpy(real).to(device), cfg, lr,
                                 tf32)
        losses.append((gl, dl))
        after.append(w)
    return losses, after


def _kernel(plan, batch: int) -> str:
    """Which of the program's kernels runs ``plan`` at ``batch``."""
    route = plan.route_for_batch(batch)
    if route.path != "cuda":
        return "other"
    tiled = route.sp_tiles is not None
    if plan.spec.kind == "transposed":
        return "D" if tiled else "A"
    return "C" if tiled else "B"


def sites(cfg: dict, train: bool, batch: int) -> list[tuple[Site, str]]:
    """Each site's shapes and the kernel that runs it at ``batch``: the
    generator's (projection first), then for training the discriminator's
    (its first conv on the image first, the head last)."""
    from repro_torch.models import gan
    layers = cfg["layers"]
    h0, c0 = layers[0][0], layers[0][1]
    pcfg = program_config(cfg)
    out = [(Site("proj", "dense", 1, cfg["z_dim"], h0 * h0 * c0), "other")]
    for i, ((hw, c, n, k, s), plan) in enumerate(
            zip(layers, gan.generator_plans(pcfg))):
        out.append((Site(f"dc{i}", "transposed", hw, c, n, k, s, bias=True),
                    _kernel(plan, batch)))
    if train:
        for i, ((hw, c, n, k, s), plan) in enumerate(
                zip(reversed(layers), gan.discriminator_plans(pcfg))):
            out.append((Site(f"c{i}", "conv", hw * s, n, c, k, s),
                        _kernel(plan, batch)))
        out.append((Site("head", "dense", 1, h0 * h0 * c0, 1), "other"))
    return out
