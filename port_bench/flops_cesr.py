"""The CESR step's operation counts (the conventions of ``flops.py``).

A multiply-add counts as 2; a count is the work the function needs at the
step's shapes, not what a kernel launches:
- the shadow net (per surface row and light, ``reference/cesr.py``): its
  input is PE10(x) (+) a one-hot of the light, so the PE columns of the
  first and the skip layer are a product a row and the one-hot columns a
  row of the weight, no product; the hidden products a (row, light) pair;
  forward and backward (the weights' and the hidden inputs' gradients) 3
  x the forward;
- the normal net (``normal_net_flops``, at the surface rows): the forward,
  the weights' gradient and the gradient of each hidden input (its input
  is PE10 of detached points: no gradient reaches it).
"""

from __future__ import annotations

from .flops import mlp_flops, n_weights, trunk_row_flops
from .reference.cesr import net_sdf
from .weights import sdf_layers

LIGHT_NSAMP, SPEC_NSAMP = 8, 8


def normal_net_row_flops(config: dict) -> int:
    """The normal net's forward and backward a surface row."""
    net = net_sdf(config, "normal_net")
    layers = sdf_layers(net)
    nw = n_weights(layers)
    # the gradient of a layer's input reaches its hidden part alone: none
    # at the first layer, the skip layer's less its encoded input
    hidden_in = nw - layers[0][0] * layers[0][1] - sum(
        net["d_in"] * layers[i][1] for i in net["skip_in"])
    return 2 * (2 * nw + hidden_in)


def shadow_net_row_flops(config: dict) -> int:
    """The shadow net's forward a surface row, over its lights."""
    net = net_sdf(config, "shadow_net")
    lights = config["model"]["envmap_material_network"]["num_lgt_sgs"]
    pe = net["d_in"] - lights
    layers = sdf_layers(net)
    inputs = [0] + list(net["skip_in"])  # the layers that read the input
    per_row = sum(pe * layers[i][1] for i in inputs)
    per_pair = n_weights(layers) - sum(net["d_in"] * layers[i][1] for i in inputs)
    return 2 * (per_row + lights * per_pair)


def cesr_step_work(config: dict, batch: int, rows: float) -> dict:
    """The CESR step's matrix work by precision at ``rows`` shaded surface
    rows of a ``batch``-pixel step (explore, the refined normal, the rgb
    loss on). fp32: the shadow net (3 x its forward), the normal net, the
    frozen NeuS's value and gradient at the rows (K3 without a graph), the
    material autoencoders (the spec-BRDF one forward and back at the rows,
    its decoder twice: the perturbed pair; its KL encoder at every pixel;
    the detached normal one forward, twice) and the frozen indirect net at
    every pixel, forward and back to the tone-map shift. bf16 (the
    visibility net's storage): the lights' sweep of 8 samples a light and
    the two specular sweeps of 8, each forward and back to its inputs."""
    model = config["model"]
    env, ind, vis = (model["envmap_material_network"], model["indirect_illum_network"],
                     model["visibility_network"])
    pe = 3 + 6 * env["multires"]
    enc = (pe, 512, 512, 512, 512, env["latent_dim"])
    dec = (env["latent_dim"], 128, 128, 5)
    ipe_enc = (6 * env["multires"],) + enc[1:]
    ind_in = 4 + 6 * ind["multires"]
    vis_trunk = mlp_flops(tuple(vis["dims"]) + (2,))
    n_dirs = env["num_lgt_sgs"] * LIGHT_NSAMP
    bf16 = 2 * rows * (n_dirs + 2 * SPEC_NSAMP) * vis_trunk
    normal_net = rows * normal_net_row_flops(config)
    fp32 = (rows * 3 * shadow_net_row_flops(config) + normal_net
            + rows * trunk_row_flops(model["neus"]["sdf"])["K3_sdf"]
            + rows * (3 * mlp_flops(enc) + 6 * mlp_flops(dec))
            + batch * 3 * mlp_flops(enc)
            + rows * 2 * (mlp_flops(ipe_enc) + mlp_flops(dec[:-1] + (3,)))
            + batch * 2 * (mlp_flops((ind_in,) + tuple(ind["dims"]) + (ind["num_lgt_sgs"] * 6,))
                           + 2 * mlp_flops((ind_in, 512, 512, 512, 512, 32))
                           + mlp_flops((32, 128, 128, 3))))
    return {"flops": {"bf16": bf16, "fp32": fp32}, "normal_net_flops": normal_net,
            "rows": {"surface": rows, "light_rows": rows * env["num_lgt_sgs"]}}
