"""The work a step or a frame needs, counted from the scene and the
camera, and the card's peaks.

Nothing here reads a count the program makes (its processed blocks, its
binned lists, its BinStats): the pairs come from the reference's own
front-to-back walk (reference/splats.py::composite with count=True),
the rest from shapes. Each constant counts float32 operations, an FMA as
2 and a special function (exp, log, sqrt, rcp) as 1.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores (the
# configurations pin float32 with TF32 off), HBM3 bandwidth; at 700 W
PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# The compositing forward, per needed pair (a pixel and a splat it keeps:
# alpha >= 1/255 while T >= 1e-4), from chip_smoke.py's per-pair
# constants: evaluating alpha (dx, dy 2; q 9; -q and exp 2; opacity x e
# 1; clamp 1; the alpha and q tests 2) 17, the depth test with a limit 1,
# the kept pair's 1 - alpha, T update, gate, log and add 5, and the
# weighted pair's alpha T and 8 channel FMAs 17.
FWD_PAIR = 17 + 5 + 17
FWD_PAIR_DEPTH_LIMIT = 1
# The backward, per needed pair: the forward's alpha (17); log, the
# log-T step, exp, 1 - alpha, the gate and the suffix term (8); gamma,
# w, dL/dalpha, dq, the suffix update, the screen terms, the geometry
# and feature products and the sums over the tile (66).
BWD_PAIR = 17 + 8 + 66
# a needed (tile, splat) entry: its 8 geometry and 8 feature floats, read
# once (forward and backward) and, in the backward, their gradients
# written once
ENTRY_BYTES = 16 * 4
# a pixel's 8 composited channels and its final log-transmittance
PIXEL_OUT_BYTES = 9 * 4
DEPTH_LIMIT_BYTES = 4


def project_flops(sh_degree: int) -> int:
    """Projection and SH colour of one Gaussian, forward: quaternion
    normalisation 12, rotation 36, scales 3, R_cw R S 63, its outer
    product 36, camera transform 21, Jacobian 10, 2D covariance 20, blur,
    determinant and conic 10, radius 10, pixel position 6, screen tests
    8, opacity 4 (239); the view direction 9, and per SH basis function
    its value and 3 channel FMAs (9 a basis)."""
    return 248 + 9 * (sh_degree + 1) ** 2


def project_bwd_flops(sh_degree: int) -> int:
    """The backward of `project_flops`: two products a forward one."""
    return 2 * project_flops(sh_degree)


# L1 + SSIM a pixel of 3 channels: L1 9; five blurred maps, each a
# separable 11-tap pass per axis (44 a channel), 660; the three product
# maps 9; SSIM's combination 45 and the means 3. The backward: the blur's
# transpose over the three maps that hold the render (396) and the
# elementwise terms (64).
LOSS_PIXEL = 9 + 660 + 9 + 45 + 3 + 396 + 64
# Adam a parameter: both moments 7, bias corrections 2, sqrt, eps and
# divide 3, the rate and the update 2
ADAM_PARAM = 14
# a mesh vertex's camera transform and projection; a (triangle, pixel)
# candidate's barycentric weights, inside test and 1/z depth
MESH_VERTEX = 27
MESH_PIXEL = 25


def composite_fwd(pairs: int, entries: int, pixels: int,
                  depth_limit: bool) -> tuple:
    """(operations, bytes) one forward launch needs."""
    ops = pairs * (FWD_PAIR + (FWD_PAIR_DEPTH_LIMIT if depth_limit else 0))
    nbytes = entries * ENTRY_BYTES + pixels * (
        PIXEL_OUT_BYTES + (DEPTH_LIMIT_BYTES if depth_limit else 0))
    return ops, nbytes


def composite_bwd(pairs: int, entries: int, pixels: int) -> tuple:
    """(operations, bytes) one backward launch needs: the entries read
    and their gradients written, each pixel's upstream gradient and final
    transmittance read."""
    return pairs * BWD_PAIR, 2 * entries * ENTRY_BYTES + pixels * PIXEL_OUT_BYTES


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card takes for the work: the larger of its
    operations over the float32 peak and its bytes over the bandwidth."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)


def train_step_flops(n_gaussians: int, sh_degree: int, pixels: int,
                     fwd_pairs: int, bwd_pairs: int) -> int:
    """One training step: projection and SH forward and backward, both
    compositing passes, the loss over the image and Adam over every
    parameter (59 floats a Gaussian at degree 3)."""
    params = n_gaussians * (3 + 4 + 3 + 1 + 3 * (sh_degree + 1) ** 2)
    return (n_gaussians * (project_flops(sh_degree)
                           + project_bwd_flops(sh_degree))
            + fwd_pairs * FWD_PAIR + bwd_pairs * BWD_PAIR
            + pixels * LOSS_PIXEL + params * ADAM_PARAM)


def frame_flops(n_gaussians: int, sh_degree: int, cameras: int,
                fwd_pairs: int, depth_limit: bool, mesh_vertices: int = 0,
                mesh_pixels: int = 0) -> int:
    """One frame of `cameras` views: each projects every Gaussian, the
    compositing forward over all views' pairs, and the mesh's vertices
    and (triangle, pixel) candidates of every view."""
    return (cameras * n_gaussians * project_flops(sh_degree)
            + fwd_pairs * (FWD_PAIR + (FWD_PAIR_DEPTH_LIMIT if depth_limit
                                       else 0))
            + cameras * mesh_vertices * MESH_VERTEX
            + mesh_pixels * MESH_PIXEL)
