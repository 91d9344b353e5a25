"""Learned point-prompted part segmentation (SAM's role, executed).

A port of robosimgs_tpu/artic/masknet.py. A small U-Net takes an RGB
render plus a prompt-point heatmap and predicts the mask of the part
under the prompt; `MaskNetGenerator.generate` is SAM's automatic mode
(grid prompts -> one batched forward -> threshold -> IoU NMS) behind the
package's `MaskGenerator` protocol, with point-prompted crops first when
a point is given. It is trained on the framework's own synthetic renders
(random multi-part assemblies rendered by render/mesh_raster.py with the
Segmenter's headlight shading).

The network is 3x3 convolutions, GroupNorm, SiLU and x2 nearest
upsampling, NCHW inside and NHWC at its boundary, with flax's semantics
where torch's defaults differ: SAME padding (a stride-2 convolution on
an even size pads (0, 1)), GroupNorm's statistics as E[x^2] - E[x]^2
clipped at 0 (summed in float64) and its epsilon 1e-6. The forward runs
on the generator's device, by default the card, and needs full f32
convolutions there.
Weights are the JAX package's file, copied byte for byte
(weights/masknet.msgpack), read by artic/flax_msgpack.py.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from robosimgs_tpu_torch.artic import flax_msgpack
from robosimgs_tpu_torch.core.convert import (masknet_params_from_numpy,
                                              masknet_params_to_numpy)
from robosimgs_tpu_torch.policy.diffusion import _lecun_normal_, _same_pad
from robosimgs_tpu_torch.utils.imresize import resize_linear, resize_nearest

DEFAULT_WEIGHTS = os.path.join(os.path.dirname(__file__), "weights",
                               "masknet.msgpack")


class _GroupNorm(nn.Module):
    """flax's GroupNorm: per (sample, group) mean and E[x^2] - E[x]^2
    (clipped at 0), y = (x - mean) * (rsqrt(var + eps) * scale) + bias.
    The statistics are summed in float64: the difference of two f32
    means cancels, and XLA's and torch's f32 reductions (in different
    orders) then part by ~1e-5 in the output; in float64 the port's
    devices agree with each other and with the exact statistics."""

    def __init__(self, channels: int, groups: int, eps: float = 1e-6):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        xg = x.reshape(b, self.groups, -1).double()
        mean = xg.mean(-1)
        var = torch.clamp_min((xg * xg).mean(-1) - mean * mean, 0.0)
        rep = c // self.groups
        mean = mean.float().repeat_interleave(rep, 1)[..., None, None]
        mul = (torch.rsqrt(var + self.eps).float().repeat_interleave(rep, 1)
               * self.weight)[..., None, None]
        return (x - mean) * mul + self.bias[:, None, None]


class MaskUNet(nn.Module):
    """Small U-Net: (B, S, S, 4) RGB+prompt-heatmap -> (B, S, S) logits.

    convs and norms are numbered in the order the forward calls them, as
    flax names Conv_i and GroupNorm_i; the weights start from flax's
    initialisers (lecun-normal kernels, zero biases, unit scales) drawn
    from `generator`."""

    def __init__(self, base: int = 16, levels: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.levels = levels
        g = generator or torch.Generator().manual_seed(0)
        specs = [(4, base, 3, 1)]                 # (in, out, kernel, stride)
        ch_in, skips = base, []
        for i in range(levels):
            skips.append(ch_in)
            ch = base * 2 ** min(i + 1, 3)
            specs += [(ch_in, ch, 3, 2), (ch, ch, 3, 1)]
            ch_in = ch
        for i in reversed(range(levels)):
            specs += [(ch_in, skips[i], 3, 1), (2 * skips[i], skips[i], 3, 1)]
            ch_in = skips[i]
        self.strides = [s for _, _, _, s in specs]
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()
        for c_in, c_out, k, _ in specs:
            self.convs.append(nn.Conv2d(c_in, c_out, k))
            self.norms.append(_GroupNorm(c_out, min(8, c_out)))
        self.convs.append(nn.Conv2d(base, 1, 1))
        with torch.no_grad():
            for conv in self.convs:
                k = conv.kernel_size[0]
                _lecun_normal_(conv.weight, k * k * conv.in_channels, g)
                conv.bias.zero_()

    def _conv_norm(self, h: torch.Tensor, i: int) -> torch.Tensor:
        conv = self.convs[i]
        if self.strides[i] == 2:
            (h_lo, h_hi), (w_lo, w_hi) = (_same_pad(h.shape[2]),
                                          _same_pad(h.shape[3]))
            h = F.conv2d(F.pad(h, (w_lo, w_hi, h_lo, h_hi)), conv.weight,
                         conv.bias, stride=2)
        else:
            h = F.conv2d(h, conv.weight, conv.bias, padding=1)
        return F.silu(self.norms[i](h))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda and torch.backends.cudnn.allow_tf32:
            raise RuntimeError("MaskUNet needs full f32 convolutions: "
                               "torch.backends.cudnn.allow_tf32 is on")
        h = self._conv_norm(x.permute(0, 3, 1, 2), 0)
        skips, i = [], 1
        for _ in range(self.levels):
            skips.append(h)
            h = self._conv_norm(self._conv_norm(h, i), i + 1)
            i += 2
        for lvl in reversed(range(self.levels)):
            h = self._conv_norm(F.interpolate(h, scale_factor=2,
                                              mode="nearest"), i)
            h = self._conv_norm(torch.cat([h, skips[lvl]], 1), i + 1)
            i += 2
        return self.convs[i](h)[:, 0]


# -- synthetic training scenes ---------------------------------------------


def _box(rng: np.random.Generator):
    s = rng.uniform(0.15, 0.6, 3)
    return _box_at(s)


def _ellipsoid(rng: np.random.Generator, sub: int = 2):
    # octahedron subdivided on the unit sphere, then scaled
    v = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                  [0, 0, 1], [0, 0, -1]], np.float32)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    for _ in range(sub):
        mid: Dict[Tuple[int, int], int] = {}
        verts = list(v)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = verts[a] + verts[b]
                m = m / np.linalg.norm(m)
                mid[key] = len(verts)
                verts.append(m)
            return mid[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        v = np.asarray(verts, np.float32)
        f = np.asarray(nf, np.int32)
    return (v * rng.uniform(0.15, 0.5, 3)).astype(np.float32), f


def _box_at(s) -> Tuple[np.ndarray, np.ndarray]:
    """Axis-aligned box with half-extents s, centered at the origin."""
    v = np.array([[x, y, z] for x in (-s[0], s[0]) for y in (-s[1], s[1])
                  for z in (-s[2], s[2])], np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return v, f


def _flap_assembly(rng: np.random.Generator):
    """Open-box-with-hinged-flap pair: an open box (four thin walls and a
    floor, part 0) and a thin plate hinged at its +x top edge, opened by a
    random angle (part 1). Returns ([(verts, faces), ...], the flap
    plate's normal)."""
    sx, sy, sz = rng.uniform(0.3, 0.6), rng.uniform(0.35, 0.7), \
        rng.uniform(0.12, 0.3)
    t = rng.uniform(0.015, 0.05)          # wall thickness
    walls = []
    for cx, hx, cy, hy in ((-sx, t, 0, sy), (sx, t, 0, sy),
                           (0, sx, -sy, t), (0, sx, sy, t)):
        v, f = _box_at(np.array([hx, hy, sz]))
        walls.append((v + np.array([cx, cy, 0], np.float32), f))
    floor_v, floor_f = _box_at(np.array([sx, sy, t]))
    walls.append((floor_v + np.array([0, 0, -sz], np.float32), floor_f))
    bv = np.concatenate([w[0] for w in walls])
    bf = np.concatenate([w[1] + 8 * i for i, w in enumerate(walls)])
    # flap: 0.2 rad = nearly closed .. 2.8 = flat open
    fl = rng.uniform(0.7, 1.4) * sx       # flap length
    fw = sy * rng.uniform(0.9, 1.1)
    ft = rng.uniform(0.01, 0.035)
    pv, pf = _box_at(np.array([fl / 2, fw, ft]))
    pv = pv + np.array([fl / 2, 0, 0], np.float32)   # hinge edge at x=0
    ang = rng.uniform(0.2, 2.8)
    ca, sa = np.cos(ang), np.sin(ang)
    R = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]], np.float32)
    pv = pv @ R.T + np.array([sx, 0, sz], np.float32)
    normal = R @ np.array([0, 0, 1], np.float32)  # flap plate normal
    return [(bv, bf), (pv, pf)], normal


def make_scene(seed: int, size: int, max_parts: int = 3,
               scan_like: bool = False, flap: bool = False, device="cuda"):
    """Random multi-part assembly rendered on `device` with the
    Segmenter's rasterizer and shading (tile capacity 1024). Returns
    (image (S, S, 3) f32, part_id (S, S) int32 with -1 = background), as
    numpy.

    scan_like=True draws all part albedos from a narrow light palette;
    flap=True makes an open-box-with-hinged-thin-flap pair instead of
    free-floating primitives. The numpy draws keep the JAX package's
    order, which reproduces the scene stream the checked-in weights were
    trained and evaluated on."""
    from robosimgs_tpu_torch.artic.render_views import shade, view_camera
    from robosimgs_tpu_torch.render.mesh_raster import (MeshRasterConfig,
                                                        rasterize_mesh)
    from robosimgs_tpu_torch.utils.meshio import Mesh, concatenate

    rng = np.random.default_rng(seed)
    parts, face_part = [], []
    view_bias = None

    def color(rng):
        if scan_like:
            base = rng.uniform(0.55, 0.85)
            return np.clip(base + rng.uniform(-0.08, 0.08, 3),
                           0.0, 1.0).astype(np.float32)
        return rng.uniform(0.15, 0.95, 3).astype(np.float32)

    if flap:
        geo, normal = _flap_assembly(rng)
        # one rigid rotation of the whole assembly (the hinge contact
        # survives), the camera biased toward the flap's face
        R = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
        geo = [(v @ R.T, f, color(rng)) for v, f in geo]
        view_bias = (R @ normal) * float(rng.choice([-1.0, 1.0]))
    else:
        n_parts = int(rng.integers(2, max_parts + 1))
        geo = []
        for p in range(n_parts):
            v, f = _box(rng) if rng.random() < 0.6 else _ellipsoid(rng)
            # random rotation (QR of a Gaussian) + offset so parts touch
            R = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
            v = v @ R.T + rng.uniform(-0.5, 0.5, 3).astype(np.float32)
            geo.append((v, f, color(rng)))
    for p, (v, f, col) in enumerate(geo):
        parts.append(Mesh(vertices=v.astype(np.float32), faces=f,
                          vertex_colors=np.tile(col, (len(v), 1))))
        face_part.append(np.full((len(f),), p, np.int32))
    mesh = concatenate(parts)
    face_part = np.concatenate(face_part)

    direction = rng.normal(size=3)
    if view_bias is not None:
        direction = view_bias + 0.45 * direction
    direction /= np.linalg.norm(direction)
    cam = view_camera(mesh, direction, size,
                      fov_deg=float(rng.uniform(40, 60)),
                      distance_factor=float(rng.uniform(1.6, 2.4)),
                      device=device)
    with torch.no_grad():
        out = rasterize_mesh(
            torch.as_tensor(mesh.vertices, device=device),
            torch.as_tensor(mesh.faces, device=device), cam,
            face_colors=torch.as_tensor(shade(mesh, cam), device=device),
            cfg=MeshRasterConfig(tile_capacity=1024))
    fid = out["face_id"].cpu().numpy()
    mask = out["mask"].cpu().numpy()
    img = np.where(mask[..., None], out["rgb"].cpu().numpy(), 1.0)
    part_id = np.where(mask, face_part[np.clip(fid, 0, len(face_part) - 1)],
                       -1).astype(np.int32)
    return img.astype(np.float32), part_id


def prompt_heatmap(size: int, u: float, v: float, sigma: float = 4.0):
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    return np.exp(-((xx - u) ** 2 + (yy - v) ** 2) / (2 * sigma**2))


def sample_example(rng: np.random.Generator, img: np.ndarray,
                   part_id: np.ndarray, crop_aug: bool = False):
    """(image, part_id) -> (input (S,S,4), target (S,S) f32), numpy.

    crop_aug: with probability 1/2, a random square crop centered near
    the prompt point, resized back to S — the distribution
    MaskNetGenerator's multi-scale prompted inference feeds the net."""
    size = img.shape[0]
    present = np.unique(part_id[part_id >= 0])
    p = int(rng.choice(present))
    ys, xs = np.nonzero(part_id == p)
    i = int(rng.integers(len(ys)))
    u, v = float(xs[i]), float(ys[i])
    tgt = (part_id == p).astype(np.float32)
    if crop_aug and rng.random() < 0.5:
        side = int(size * rng.uniform(0.3, 0.8))
        x0 = int(np.clip(u - side / 2 + rng.uniform(-side / 4, side / 4),
                         0, size - side))
        y0 = int(np.clip(v - side / 2 + rng.uniform(-side / 4, side / 4),
                         0, size - side))
        img = resize_linear(torch.from_numpy(np.ascontiguousarray(
            img[y0:y0 + side, x0:x0 + side], np.float32)), size, size).numpy()
        tgt = resize_nearest(tgt[y0:y0 + side, x0:x0 + side], size, size)
        u = np.clip((u - x0) * size / side, 0, size - 1)
        v = np.clip((v - y0) * size / side, 0, size - 1)
    heat = prompt_heatmap(size, u, v)
    x = np.concatenate([img, heat[..., None]], axis=-1).astype(np.float32)
    return x, tgt


# -- training ---------------------------------------------------------------


@dataclasses.dataclass
class MaskNetTrainResult:
    params: dict              # MaskUNet state dict, CPU tensors
    holdout_iou: float
    losses: List[float]


def masknet_loss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """optax's sigmoid binary cross-entropy (mean) plus the soft dice
    term (mean over the batch)."""
    bce = (-y * F.logsigmoid(logits)
           - (1.0 - y) * F.logsigmoid(-logits)).mean()
    prob = torch.sigmoid(logits)
    inter = (prob * y).sum((1, 2))
    dice = 1.0 - (2 * inter + 1.0) / (prob.sum((1, 2)) + y.sum((1, 2)) + 1.0)
    return bce + dice.mean()


def cosine_lr(lr: float, steps: int, count: int) -> float:
    """optax.cosine_decay_schedule(lr, steps) at `count`."""
    c = min(count, steps)
    return lr * 0.5 * (1.0 + math.cos(math.pi * c / steps))


def train_masknet(
    steps: int = 600,
    size: int = 96,
    batch: int = 16,
    n_scenes: int = 120,
    lr: float = 2e-3,
    seed: int = 0,
    log_every: int = 0,
    progress: Optional[Callable[[int], None]] = None,
    init_params: Optional[dict] = None,
    flap_frac: float = 0.0,
    crop_aug: bool = False,
    device="cuda",
) -> MaskNetTrainResult:
    """Train MaskUNet on synthetic assemblies on `device`; returns the
    parameters and the held-out prompt-mask IoU (scenes unseen during
    training).

    The optimizer is optax.adamw's: b1 0.9, b2 0.999, eps 1e-8 outside
    the square root, decoupled weight decay 1e-4 on every parameter,
    under the cosine decay read at the count before the update.
    init_params: a state dict to start from (fine-tuning), else flax's
    initialisers drawn from a generator seeded `seed`. flap_frac: the
    share of open-box-with-hinged-flap scenes; crop_aug: random
    prompt-centered crops."""
    rng = np.random.default_rng(seed)
    scenes = [_train_scene(1000 + s, s, size, flap_frac, device)
              for s in range(n_scenes)]
    holdout = holdout_scenes(size, flap_frac, device)

    model = MaskUNet(generator=torch.Generator().manual_seed(seed))
    if init_params is not None:
        model.load_state_dict(init_params)
    model.to(device)
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)

    losses = []
    for step in range(steps):
        xs, ys = [], []
        for _ in range(batch):
            img, pid = scenes[int(rng.integers(len(scenes)))]
            x, y = sample_example(rng, img, pid, crop_aug=crop_aug)
            xs.append(x)
            ys.append(y)
        for group in opt.param_groups:
            group["lr"] = cosine_lr(lr, steps, step)
        loss = masknet_loss(model(torch.from_numpy(np.stack(xs)).to(device)),
                            torch.from_numpy(np.stack(ys)).to(device))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if log_every and step % log_every == 0:
            print(f"masknet step {step}: loss {losses[-1]:.4f}", flush=True)
        if progress is not None:
            progress(step)

    params = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return MaskNetTrainResult(params=params,
                              holdout_iou=prompt_iou(model, holdout, device),
                              losses=losses)


def _train_scene(seed: int, s: int, size: int, flap_frac: float, device):
    """Scene s of a training or held-out set: 1/3 scan-like low-contrast
    scenes; the first flap_frac of every 100 flap scenes, which lean
    scan-like harder (2/3)."""
    is_flap = (s % 100) < int(flap_frac * 100)
    scan = (s % 3 != 0) if is_flap else (s % 3 == 2)
    return make_scene(seed, size, scan_like=scan, flap=is_flap, device=device)


def holdout_scenes(size: int, flap_frac: float = 0.0, device="cuda"):
    """train_masknet's 12 held-out scenes (unseen in training) for its
    flap_frac."""
    return [_train_scene(999_000 + s, s, size, flap_frac, device)
            for s in range(12)]


def prompt_iou(model: MaskUNet, scenes, device="cuda") -> float:
    """Mean prompt-mask IoU of `model` over scenes: one prompt each
    (sample_example drawn from a generator seeded 7), thresholded at
    0.5."""
    ious = []
    with torch.no_grad():
        for img, pid in scenes:
            x, y = sample_example(np.random.default_rng(7), img, pid)
            prob = torch.sigmoid(model(torch.from_numpy(x[None]).to(device)))
            pred = prob[0].cpu().numpy() > 0.5
            inter = (pred & (y > 0.5)).sum()
            union = (pred | (y > 0.5)).sum()
            ious.append(inter / max(union, 1))
    return float(np.mean(ious))


def save_params(params: dict, path: str = DEFAULT_WEIGHTS) -> None:
    """Write a MaskUNet state dict in flax's msgpack format (what the JAX
    package's load_params reads)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(flax_msgpack.dumps(masknet_params_to_numpy(params)))


def load_params(path: str = DEFAULT_WEIGHTS) -> dict:
    """A MaskUNet state dict (CPU tensors) from a flax msgpack file."""
    with open(path, "rb") as fh:
        return masknet_params_from_numpy(flax_msgpack.loads(fh.read()))


# -- automatic mask generation (the MaskGenerator protocol) ------------------


class MaskNetGenerator:
    """SAM-style automatic mask generation from the learned prompt net:
    a grid of point prompts over the (non-background) image, one batched
    forward on `device`, threshold, greedy IoU NMS. Satisfies
    `robosimgs_tpu_torch.artic.mllm.MaskGenerator`."""

    def __init__(self, params: Optional[dict] = None, size: int = 96,
                 grid: int = 6, threshold: float = 0.5,
                 nms_iou: float = 0.75, min_area_px: int = 16,
                 device="cuda"):
        if params is None:
            params = load_params()
        self.size = size
        self.grid = grid
        self.threshold = threshold
        self.nms_iou = nms_iou
        self.min_area_px = min_area_px
        self.device = torch.device(device)
        self.model = MaskUNet()
        self.model.load_state_dict(params)
        self.model.to(self.device).eval()

    def probs(self, x: torch.Tensor) -> np.ndarray:
        """sigmoid(MaskUNet(x)) of a (B, S, S, 4) batch on the device, as
        numpy."""
        with torch.no_grad():
            return torch.sigmoid(self.model(x)).cpu().numpy()

    def _input(self, small: torch.Tensor, prompts) -> torch.Tensor:
        S = self.size
        # a float64 prompt (a grid coordinate) makes a float64 heatmap,
        # rounded to float32 here as the JAX package's input is
        heat = torch.from_numpy(np.stack([prompt_heatmap(S, u, v)
                                          for u, v in prompts]
                                         ).astype(np.float32))
        return torch.cat([small.expand(len(prompts), S, S, 3),
                          heat.to(self.device)[..., None]], -1)

    def generate(self, image: np.ndarray,
                 point: Optional[Tuple[float, float]] = None
                 ) -> List[np.ndarray]:
        """Automatic grid candidates; with `point` (full-res (u, v)),
        point-prompted candidates at multiple crop scales around it come
        first (SAM's interactive mode). The crops recover thin parts that
        vanish at the 96^2 full-frame working size."""
        out = self._prompted(image, point) if point is not None else []
        out.extend(self._automatic(image))
        return out

    def _resized(self, image: np.ndarray) -> torch.Tensor:
        img = torch.as_tensor(np.ascontiguousarray(image, np.float32),
                              device=self.device)
        return resize_linear(img, self.size, self.size)

    def _prompted(self, image: np.ndarray,
                  point: Tuple[float, float]) -> List[np.ndarray]:
        H, W = image.shape[:2]
        S = self.size
        u0, v0 = float(point[0]), float(point[1])
        cands: List[np.ndarray] = []
        for scale in (1.0, 0.5, 0.25):
            side = max(int(round(scale * max(H, W))), S // 2)
            x0 = int(np.clip(round(u0 - side / 2), 0, max(W - side, 0)))
            y0 = int(np.clip(round(v0 - side / 2), 0, max(H - side, 0)))
            x1, y1 = min(x0 + side, W), min(y0 + side, H)
            crop = image[y0:y1, x0:x1]
            ch, cw = crop.shape[:2]
            pu = (u0 - x0) * S / cw
            pv = (v0 - y0) * S / ch
            prob = self.probs(self._input(self._resized(crop), [(pu, pv)]))[0]
            m = prob > self.threshold
            if m.sum() < self.min_area_px:
                continue
            full = np.zeros((H, W), bool)
            full[y0:y1, x0:x1] = resize_nearest(m, ch, cw)
            cands.append(full)
        # dedup across scales (keep the sharpest = smallest-crop first)
        keep: List[np.ndarray] = []
        for m in reversed(cands):
            if not any((m & k).sum() / max((m | k).sum(), 1) > self.nms_iou
                       for k in keep):
                keep.append(m)
        return keep

    def _automatic(self, image: np.ndarray) -> List[np.ndarray]:
        H, W = image.shape[:2]
        S = self.size
        small = self._resized(image)
        host = small.cpu().numpy()
        # grid prompts, skipping (near-)background points
        coords = np.linspace(S * 0.08, S * 0.92, self.grid)
        prompts = [(u, v) for v in coords for u in coords
                   if np.abs(host[int(v), int(u)] - 1.0).sum() > 0.08]
        if not prompts:
            prompts = [(S / 2, S / 2)]
        probs = self.probs(self._input(small, prompts))    # (B, S, S)
        masks, quals = [], []
        for b in range(probs.shape[0]):
            m = probs[b] > self.threshold
            if m.sum() < self.min_area_px:
                continue
            masks.append(m)
            quals.append(float(probs[b][m].mean()))
        # greedy NMS by predicted quality
        keep: List[np.ndarray] = []
        for i in np.argsort(quals)[::-1]:
            m = masks[i]
            dup = any((m & k).sum() / max((m | k).sum(), 1) > self.nms_iou
                      for k in keep)
            if not dup:
                keep.append(m)
        # upsample to full resolution (nearest)
        return [resize_nearest(m, H, W) for m in keep]
