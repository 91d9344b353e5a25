"""Plain 3DGS training steps: render, L1 + SSIM, gradients, Adam.

  * loss = (1 - lambda) L1 + lambda (1 - SSIM), lambda 0.2; SSIM with an
    11-tap Gaussian window (sigma 1.5), zero padding, C1 = 0.01^2,
    C2 = 0.03^2, averaged over pixels and channels;
  * SH band b is active from step b * sh_warmup_every (inactive
    coefficients multiplied by 0 inside the loss);
  * Adam as optax counts it, one group a parameter: the count is raised
    before the bias correction; the means' rate decays log-linearly from
    means_lr_init to means_lr_final (times the scene extent) over
    means_lr_max_steps, read at the group's schedule count before it is
    raised, so the first update uses the initial rate.

The image is composited without autograd, the loss's gradient taken on
the image, and each block of tiles composited again with autograd to
carry it to the splats (splats.composite's grad_out).
"""

from __future__ import annotations

import math

import torch

from portbench.reference import splats

FIELDS = ("means", "quats", "log_scales", "logit_opacities", "sh_dc",
          "sh_rest")


def _window(device) -> torch.Tensor:
    x = torch.arange(11, dtype=torch.float64) - 5
    w = torch.exp(-(x * x) / (2 * 1.5 ** 2))
    return (w / w.sum()).to(torch.float32).to(device)


def _blur(img: torch.Tensor) -> torch.Tensor:
    """(C, H, W) -> the same, separable 11-tap Gaussian, zero padding."""
    w = splats.tf32(_window(img.device))
    c = img.shape[0]
    x = torch.nn.functional.conv2d(splats.tf32(img[None]), w.view(
        1, 1, 1, 11).repeat(c, 1, 1, 1), padding=(0, 5), groups=c)
    x = torch.nn.functional.conv2d(splats.tf32(x), w.view(1, 1, 11, 1).repeat(
        c, 1, 1, 1), padding=(5, 0), groups=c)
    return x[0]


def ssim(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of (H, W, C) images."""
    p, t = pred.permute(2, 0, 1), target.permute(2, 0, 1)
    mp, mt = _blur(p), _blur(t)
    spp = _blur(p * p) - mp * mp
    stt = _blur(t * t) - mt * mt
    spt = _blur(p * t) - mp * mt
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return torch.mean((2 * mp * mt + c1) * (2 * spt + c2)
                      / ((mp * mp + mt * mt + c1) * (spp + stt + c2)))


def photometric(pred: torch.Tensor, target: torch.Tensor,
                lam: float) -> torch.Tensor:
    return ((1 - lam) * torch.mean(torch.abs(pred - target))
            + lam * (1 - ssim(pred, target)))


def render(params: dict, cam: dict, rc: dict, background=None) -> dict:
    """{rgb over the background (black if None), alpha, depth} of one
    view, no autograd."""
    with torch.no_grad():
        proj = splats.project(params, cam, rc)
        out = splats.composite(proj, cam["width"], cam["height"], rc)
    rgb = out["rgb"]
    if background is not None:
        rgb = rgb + (1 - out["alpha"])[..., None] * background
    return {"rgb": rgb, "alpha": out["alpha"], "depth": out["depth"]}


def loss_and_grads(params: dict, cam: dict, target: torch.Tensor,
                   rc: dict, tc: dict, step: int, half_rows: bool = False):
    """(loss, {field: gradient}) of one training step's loss at the
    trainer step `step`. half_rows leaves the lower half of the image's
    rows out of the loss (a planted fault: half of the batch dropped,
    the mean taken over the rest)."""
    bg = torch.tensor(tc["background"], dtype=torch.float32,
                      device=target.device)
    leaves = {k: params[k].detach().requires_grad_(True) for k in FIELDS}
    n_rest = params["sh_rest"].shape[1]
    band = torch.floor(torch.sqrt(torch.arange(1, n_rest + 1,
                                               dtype=torch.float32)))
    mask = (band <= step // tc["sh_warmup_every"]).to(
        torch.float32).to(target.device)[:, None]
    p = {**params, **leaves, "sh_rest": leaves["sh_rest"] * mask}
    with torch.enable_grad():
        proj = splats.project(p, cam, rc)
    with torch.no_grad():
        img = splats.composite({k: v.detach() if torch.is_tensor(v) else v
                                for k, v in proj.items()},
                               cam["width"], cam["height"], rc)
    rgb = img["rgb"].detach().requires_grad_(True)
    alpha = img["alpha"].detach().requires_grad_(True)
    with torch.enable_grad():
        full = rgb + (1 - alpha)[..., None] * bg
        if half_rows:
            h = full.shape[0] // 2
            loss = photometric(full[:h], target[:h], tc["ssim_lambda"])
        else:
            loss = photometric(full, target, tc["ssim_lambda"])
        g_rgb, g_alpha = torch.autograd.grad(loss, [rgb, alpha])
    back = splats.composite(proj, cam["width"], cam["height"], rc,
                            grad_out={"rgb": g_rgb, "alpha": g_alpha},
                            tile_block=64)["grads"]
    with torch.enable_grad():
        outs = [proj[k] for k in back]
        grads = torch.autograd.grad(outs, [leaves[k] for k in FIELDS],
                                    grad_outputs=list(back.values()),
                                    allow_unused=True)
    return float(loss.detach()), {k: torch.zeros_like(leaves[k]) if g is None else g
                         for k, g in zip(FIELDS, grads)}


def adam_init(params: dict) -> dict:
    return {k: {"mu": torch.zeros_like(params[k]),
                "nu": torch.zeros_like(params[k]), "count": 0}
            for k in FIELDS}


def adam_step(params: dict, grads: dict, state: dict, oc: dict,
              extent: float) -> tuple:
    """One Adam update of every group: (new params, new state)."""
    b1, b2, eps = oc["b1"], oc["b2"], oc["eps"]
    rates = {"quats": oc["quat_lr"], "log_scales": oc["scale_lr"],
             "logit_opacities": oc["opacity_lr"], "sh_dc": oc["sh_dc_lr"],
             "sh_rest": oc["sh_rest_lr"]}
    new_p, new_s = dict(params), {}
    for k in FIELDS:
        s, g = state[k], grads[k]
        mu = b1 * s["mu"] + (1 - b1) * g
        nu = b2 * s["nu"] + (1 - b2) * g * g
        count = s["count"] + 1
        upd = (mu / (1 - b1 ** count)) / (torch.sqrt(nu / (1 - b2 ** count))
                                          + eps)
        if k == "means":
            t = min(max(s["count"] / oc["means_lr_max_steps"], 0.0), 1.0)
            lr = math.exp((1 - t) * math.log(oc["means_lr_init"] * extent)
                          + t * math.log(oc["means_lr_final"] * extent))
        else:
            lr = rates[k]
        new_p[k] = params[k] - lr * upd
        new_s[k] = {"mu": mu, "nu": nu, "count": count}
    return new_p, new_s


def train(params: dict, cams: list, targets: list, rc: dict, tc: dict,
          first_step: int, steps: int, half_rows: bool = False) -> dict:
    """`steps` training steps from `params` and a fresh Adam state, step s
    on view s % len(cams): {"losses", "first_grads", "params"}."""
    state = adam_init(params)
    losses, first = [], None
    for i in range(steps):
        s = first_step + i
        v = s % len(cams)
        loss, grads = loss_and_grads(params, cams[v], targets[v], rc, tc, s,
                                     half_rows)
        losses.append(loss)
        if first is None:
            first = grads
        params, state = adam_step(params, grads, state, tc["optim"],
                                  tc["scene_extent"])
    return {"losses": losses, "first_grads": first, "params": params}
