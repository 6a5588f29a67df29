"""Seeded weights, made on the device from the seed in a few large calls.

The benchmark hands the same weights to the program (copied into its
parameters before the first step) and to the reference. The names are the
program's parameter paths (``sdf_network.lin0.v``); the distributions are
the NeuS initialisations: the SAL geometric init of the SDF trunk (a
sphere of radius ``bias``), ``torch.nn.Linear``'s uniform init elsewhere,
weight norm (``v``, ``g = |v|`` per column, ``b``) where the config has it.
"""

from __future__ import annotations

import math

import torch


def pe_dim(d_in: int, multires: int) -> int:
    return d_in + 2 * multires * d_in if multires > 0 else d_in


def sdf_layers(sdf: dict) -> list[tuple[int, int]]:
    """(in, out) of each linear layer of the SDF trunk: ``n_layers`` hidden
    layers of ``d_hidden``, the layer before a skip narrowed by the encoded
    input's width so that the concatenation is ``d_hidden`` wide."""
    d0 = pe_dim(sdf["d_in"], sdf["multires"])
    dims = [d0] + [sdf["d_hidden"]] * sdf["n_layers"] + [sdf["d_out"]]
    return [(dims[i], dims[i + 1] - d0 if i + 1 in sdf["skip_in"] else dims[i + 1])
            for i in range(len(dims) - 1)]


def color_layers(color: dict) -> list[tuple[int, int]]:
    """(in, out) of each layer of the IDR colour net: [points, PE(view
    direction), normal, feature] in, ``n_layers`` of ``d_hidden``, 3 out."""
    d0 = color["d_in"] + color["d_feature"] + (pe_dim(3, color["multires_view"]) - 3)
    dims = [d0] + [color["d_hidden"]] * color["n_layers"] + [color["d_out"]]
    return [(dims[i], dims[i + 1]) for i in range(len(dims) - 1)]


def _weight_norm(prefix: str, w: torch.Tensor, b: torch.Tensor) -> dict:
    return {f"{prefix}.v": w, f"{prefix}.g": torch.linalg.norm(w, dim=0), f"{prefix}.b": b}


def neus_weights(model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The NeuS tree (``sdf_network``, ``color_network``,
    ``deviation_network``) of a stage-1 ``model`` section, fp32 on
    ``device``."""
    sdf, color = model["sdf"], model["color"]
    gen = torch.Generator(device=device).manual_seed(seed)
    layers = sdf_layers(sdf)
    d0 = layers[0][0]
    normal = torch.randn(sum(i * o for i, o in layers), generator=gen, device=device)
    out, off = {}, 0
    for li, (n_in, n_out) in enumerate(layers):
        z = normal[off:off + n_in * n_out].reshape(n_in, n_out)
        off += n_in * n_out
        b = torch.zeros(n_out, device=device)
        if li == len(layers) - 1:
            w = math.sqrt(math.pi) / math.sqrt(n_in) + 1e-4 * z
            b = b - sdf["bias"]
        else:
            w = math.sqrt(2) / math.sqrt(n_out) * z
            if li == 0 and sdf["multires"] > 0:
                w[3:] = 0.0
            elif li in sdf["skip_in"] and sdf["multires"] > 0:
                w[-(d0 - 3):] = 0.0
        out.update(_weight_norm(f"sdf_network.lin{li}", w, b))
    clayers = color_layers(color)
    uniform = torch.rand(sum((i + 1) * o for i, o in clayers), generator=gen, device=device)
    off = 0
    for li, (n_in, n_out) in enumerate(clayers):
        u = uniform[off:off + (n_in + 1) * n_out] * 2 - 1
        off += (n_in + 1) * n_out
        bound = 1.0 / math.sqrt(n_in)
        out.update(_weight_norm(f"color_network.lin{li}",
                                (u[:n_in * n_out] * bound).reshape(n_in, n_out),
                                u[n_in * n_out:] * bound))
    out["deviation_network.variance"] = torch.tensor(model["variance"]["init_val"],
                                                     device=device)
    return out


def nest(flat: dict) -> dict:
    """``{"a.b.c": leaf}`` -> ``{"a": {"b": {"c": leaf}}}``."""
    out: dict = {}
    for k, v in flat.items():
        node = out
        *parents, leaf = k.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _ae_layers(in_dim: int, out_dim: int, latent: int, enc=(512, 512, 512, 512),
               dec=(128, 128)) -> list[tuple[str, int, int]]:
    e = (in_dim,) + tuple(enc) + (latent,)
    d = (latent,) + tuple(dec) + (out_dim,)
    return ([(f"encoder.lin{i}", e[i], e[i + 1]) for i in range(len(e) - 1)]
            + [(f"decoder.lin{i}", d[i], d[i + 1]) for i in range(len(d) - 1)])


def _mlp_layers(dims) -> list[tuple[str, int, int]]:
    return [(f"lin{i}", dims[i], dims[i + 1]) for i in range(len(dims) - 1)]


def stage2_plain_layers(model: dict) -> list[tuple[str, int, int]]:
    """(path, in, out) of every plain linear layer of the stage-2 tree:
    the three autoencoders of the material net, the indirect net, the
    visibility net and the energy net."""
    env, ind, vis = (model["envmap_material_network"], model["indirect_illum_network"],
                     model["visibility_network"])
    latent = env["latent_dim"]
    pe = pe_dim(3, env["multires"])
    ipe = 2 * env["multires"] * 3
    ind_in = pe_dim(3, ind["multires"]) + 1
    out = []
    for name, n_in, n_out in (("brdf_encoder_layer", pe, 5), ("spec_brdf_encoder_layer", pe, 5),
                              ("normal_decoder_layer", ipe, 3)):
        out += [(f"envmap_material_network.{name}.{p}", i, o)
                for p, i, o in _ae_layers(n_in, n_out, latent)]
    out += [(f"indirect_illum_network.lobe_layer.{p}", i, o) for p, i, o in
            _mlp_layers((ind_in,) + tuple(ind["dims"]) + (ind["num_lgt_sgs"] * 6,))]
    out += [(f"indirect_illum_network.integral_layer.{p}", i, o)
            for p, i, o in _ae_layers(ind_in, 3, 32)]
    out += [(f"visibility_network.{p}", i, o) for p, i, o in _mlp_layers(
        (pe_dim(3, vis["points_multires"]) + pe_dim(3, vis["dirs_multires"]),)
        + tuple(vis["dims"]) + (2,))]
    out += [(f"gamma.energy.{p}", i, o) for p, i, o in _mlp_layers((9, 128, 128, 64, 3))]
    return out


def _fibonacci(n: int) -> torch.Tensor:
    i = torch.arange(n, dtype=torch.float64)
    y = 1 - (i / float(n - 1)) * 2
    r = torch.sqrt(1 - y * y)
    theta = math.pi * (3.0 - math.sqrt(5.0)) * i
    return torch.stack([torch.cos(theta) * r, y, torch.sin(theta) * r], -1).float()


def light_sgs(gen: torch.Generator, m: int, device) -> torch.Tensor:
    """The SG lights [m, 7] (RobIR's ``sg_envmap_material.py`` init): gray
    amplitudes, sharpness 10 + |20 z|, total energy 0.8 x 2 pi a channel,
    Fibonacci lobes repeated over the two halves."""
    sgs = torch.randn((m, 7), generator=gen, device=device)
    sgs[:, 5:] = sgs[:, 4:5]
    sgs[:, 3:4] = 10.0 + torch.abs(sgs[:, 3:4] * 20.0)
    lam, mu = sgs[:, 3:4], torch.abs(sgs[:, 4:])
    energy = mu * 2.0 * math.pi / lam * (1.0 - torch.exp(-2.0 * lam))
    sgs[:, 4:] = mu / energy.sum(0, keepdim=True) * 2.0 * math.pi * 0.8
    lobes = _fibonacci(m // 2).to(device)
    sgs[:m // 2, :3] = lobes
    sgs[m // 2:, :3] = lobes
    return sgs


def stage2_weights(model: dict, seed: int, device,
                   neus_seed: int | None = None) -> dict[str, torch.Tensor]:
    """The stage-2 tree of a stage-2 ``model`` section, flat by path, fp32
    on ``device``: the frozen NeuS (``implicit_network``, as
    ``neus_weights``, of ``neus_seed`` where given, else of ``seed``), the
    plain layers at ``torch.nn.Linear``'s init, the lights, the Fresnel
    constant and the tone-map scalars. The frozen NeuS is the geometry,
    which sets the surface rows and so the step's work: a mix that fixes
    its seed gives every run seed the same work."""
    out = {f"implicit_network.{k}": v for k, v in neus_weights(
        model["neus"], seed if neus_seed is None else neus_seed, device).items()}
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    layers = stage2_plain_layers(model)
    u = torch.rand(sum((i + 1) * o for _, i, o in layers), generator=gen, device=device) * 2 - 1
    off = 0
    for path, n_in, n_out in layers:
        bound = 1.0 / math.sqrt(n_in)
        out[f"{path}.w"] = (u[off:off + n_in * n_out] * bound).reshape(n_in, n_out)
        out[f"{path}.b"] = u[off + n_in * n_out:off + (n_in + 1) * n_out] * bound
        off += (n_in + 1) * n_out
    env = model["envmap_material_network"]
    out["envmap_material_network.specular_reflectance"] = torch.full(
        (1, 1), float(env["specular_albedo"]), device=device)
    out["envmap_material_network.lgtSGs"] = light_sgs(gen, env["num_lgt_sgs"], device)
    for k, v in (("gamma", model["tonemap"]["gamma"]), ("indir_coef", 1.0), ("dir_coef", 2.0),
                 ("coef", 1.0), ("adapt_illum", 0.0)):
        out[f"gamma.{k}"] = torch.tensor(float(v), device=device)
    return out
