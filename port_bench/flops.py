"""The benchmark's own operation counts and the card's published peaks.

A multiply-add counts as 2. The SDF trunk's per-row counts are the work
the function needs, not what a kernel launches (K4 recomputes K3's
passes, K1 writes every output column): with nw the trunk's weights and
ns those with the last layer cut to the SDF column (524,544 and 459,008
at 8 x 256 with multires 10 or 6),
- ``K1`` (the forward, every column) 2 x nw; ``K1_sdf`` (the SDF column
  alone, as the sampling queries use it) 2 x ns;
- ``K3`` (the forward, every column, and the spatial gradient's reverse
  pass from the SDF column) 2 x nw + 2 x ns; ``K3_sdf`` (value and
  gradient alone) 4 x ns;
- ``K4`` (K3's backward: the data gradient and dW of both passes, with
  every column's gradient coming in) 4 x nw + 4 x ns.
"""

from __future__ import annotations

from .weights import color_layers, sdf_layers

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}


def n_weights(layers) -> int:
    return sum(i * o for i, o in layers)


def trunk_row_flops(sdf: dict) -> dict[str, int]:
    layers = sdf_layers(sdf)
    nw = n_weights(layers)
    ns = nw - layers[-1][0] * (layers[-1][1] - 1)
    return {"K1": 2 * nw, "K1_sdf": 2 * ns, "K3": 2 * nw + 2 * ns, "K3_sdf": 4 * ns,
            "K4": 4 * nw + 4 * ns}


def neus_step_work(model: dict, render: dict, batch: int) -> dict:
    """The stage-1 step's matrix work by precision, and the trunk's alone:
    the SDF column at the sampling queries (the first ``n_samples`` and
    every up-sampling round but the last), K3 and K4 at every shaded
    sample, the bf16 colour net forward and backward (3 x its forward) at
    every shaded sample."""
    steps = render["up_sample_steps"]
    per_round = render["n_importance"] // steps
    k1_rows = batch * (render["n_samples"] + per_round * (steps - 1))
    shaded = batch * (render["n_samples"] + render["n_importance"])
    row = trunk_row_flops(model["sdf"])
    trunk = k1_rows * row["K1_sdf"] + shaded * (row["K3"] + row["K4"])
    color = shaded * 3 * 2 * n_weights(color_layers(model["color"]))
    return {"trunk_flops": trunk, "flops": {"fp32": trunk, "bf16": color},
            "rows": {"K1": k1_rows, "K3": shaded, "K4": shaded}}


def least_seconds(flops: dict[str, float]) -> float:
    """The least time of matrix work by precision at the published peaks."""
    return sum(n / PEAK_FLOPS[p] for p, n in flops.items())


def mlp_flops(dims) -> int:
    """Forward FLOPs a row of a dense chain through ``dims``."""
    return 2 * sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))


def pbr_step_work(model: dict, batch: int, rows: float) -> dict:
    """The PBR step's matrix work by precision at ``rows`` shaded surface
    rows of a ``batch``-pixel step. bf16 (the visibility net's storage):
    the diffuse sweep over rows x lights x samples directions and the two
    specular sweeps, each forward and back to its inputs (the sweep's
    directions carry the lights' gradient). fp32: the geometry normals
    (the SDF's value and gradient alone: no feature is used);
    the trainable spec-BRDF autoencoder at the rows (forward and both
    backward products, its perturbed decode too) and its KL encoder at
    every pixel; the frozen normal decoder at the rows (forward, twice:
    the perturbed input); the frozen indirect net at every pixel, forward
    and back to the tone-map shift it takes."""
    env, ind, vis = (model["envmap_material_network"], model["indirect_illum_network"],
                     model["visibility_network"])
    pe = 3 + 6 * env["multires"]
    enc = (pe, 512, 512, 512, 512, env["latent_dim"])
    dec = (env["latent_dim"], 128, 128, 5)
    ipe_enc = (6 * env["multires"],) + enc[1:]
    ind_in = 4 + 6 * ind["multires"]
    vis_trunk = mlp_flops(tuple(vis["dims"]) + (2,))
    n_dirs = env["num_lgt_sgs"] * 32
    bf16 = 2 * rows * (n_dirs + 2 * 8) * vis_trunk
    fp32 = (rows * trunk_row_flops(model["neus"]["sdf"])["K3_sdf"]
            + rows * (3 * mlp_flops(enc) + 6 * mlp_flops(dec))
            + batch * 3 * mlp_flops(enc)
            + rows * 2 * (mlp_flops(ipe_enc) + mlp_flops(dec[:-1] + (3,)))
            + batch * 2 * (mlp_flops((ind_in,) + tuple(ind["dims"]) + (ind["num_lgt_sgs"] * 6,))
                           + 2 * mlp_flops((ind_in, 512, 512, 512, 512, 32))
                           + mlp_flops((32, 128, 128, 3))))
    return {"flops": {"bf16": bf16, "fp32": fp32}, "rows": {"surface": rows}}
