"""Learnable illumination (an SG mixture) and the spatially varying BRDF
heads (counterpart of ``robir_tpu/fields/envmap_material.py``).

- ``lgtSGs`` [M, 7]: gray-mu randn init, lambda = 10 + |20 z|, energy
  normalised to 2 pi * 0.8, fibonacci lobes duplicated across the halves;
- three SparseAE heads: diffuse BRDF (legacy, unused by the forward),
  spec BRDF (albedo 3 + roughness 1 + metallic 1, sigmoid out, roughness
  * 0.9 + 0.09 and metallic * 0.99 + 0.01), and the normal decoder
  (IPE(var=1e-5) input, no out activation, smoothness on the input);
- the scalar Fresnel ``specular_reflectance``;
- the optional upper-hemisphere lobe restriction;
- for relighting, ``get_light`` (the lights without a graph) and
  ``load_light`` (prefit SGs and their envmap image in place of the
  learnt lights).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .encoding import IPEConfig, PEConfig, integrated_pos_enc, positional_encoding
from .mlp import Params
from .sparse_ae import SparseAEConfig, init_sparse_ae, sparse_ae_apply


def fibonacci_sphere(samples: int) -> np.ndarray:
    """Golden-angle uniform sphere points (sg_envmap_material.py:12-30)."""
    i = np.arange(samples, dtype=np.float64)
    phi = np.pi * (3.0 - np.sqrt(5.0))
    y = 1 - (i / float(samples - 1)) * 2
    radius = np.sqrt(1 - y * y)
    theta = phi * i
    return np.stack([np.cos(theta) * radius, y, np.sin(theta) * radius], -1)


def compute_energy(lgt_sgs: np.ndarray) -> np.ndarray:
    """Per-SG total energy (sg_envmap_material.py:33-37)."""
    lam = np.abs(lgt_sgs[:, 3:4])
    mu = np.abs(lgt_sgs[:, 4:])
    return mu * 2.0 * np.pi / lam * (1.0 - np.exp(-2.0 * lam))


@dataclasses.dataclass(frozen=True)
class EnvmapMaterialConfig:
    multires: int = 10
    num_lgt_sgs: int = 128
    upper_hemi: bool = False
    specular_albedo: float = 0.05
    latent_dim: int = 32
    encoder_dims: tuple[int, ...] = (512, 512, 512, 512)
    decoder_dims: tuple[int, ...] = (128, 128)
    spec_lc_act: str = "sigmoid"

    @property
    def pe(self) -> PEConfig:
        return PEConfig(num_freqs=self.multires, input_dims=3)

    @property
    def ipe(self) -> IPEConfig:
        return IPEConfig(min_deg=0, max_deg=self.multires, input_dims=3)

    @property
    def brdf_ae(self) -> SparseAEConfig:
        return SparseAEConfig(in_dim=self.pe.out_dim, out_dim=5,
                              latent_dim=self.latent_dim, out_act=None,
                              encoder_dims=self.encoder_dims,
                              decoder_dims=self.decoder_dims)

    @property
    def spec_brdf_ae(self) -> SparseAEConfig:
        return SparseAEConfig(in_dim=self.pe.out_dim, out_dim=5,
                              latent_dim=self.latent_dim, out_act="sigmoid",
                              lc_act=self.spec_lc_act,
                              encoder_dims=self.encoder_dims,
                              decoder_dims=self.decoder_dims)

    @property
    def normal_ae(self) -> SparseAEConfig:
        return SparseAEConfig(in_dim=self.ipe.out_dim, out_dim=3,
                              latent_dim=self.latent_dim, out_act=None,
                              smooth_on_latent=False,
                              encoder_dims=self.encoder_dims,
                              decoder_dims=self.decoder_dims)


def init_lgt_sgs(gen: torch.Generator, cfg: EnvmapMaterialConfig) -> torch.Tensor:
    """Reference lgtSGs init (sg_envmap_material.py:161-177)."""
    m = cfg.num_lgt_sgs
    sgs = torch.randn((m, 7), generator=gen).numpy().astype(np.float32)
    sgs[:, -2:] = sgs[:, -3:-2]  # gray mu
    sgs[:, 3:4] = 10.0 + np.abs(sgs[:, 3:4] * 20.0)
    energy = compute_energy(sgs)
    sgs[:, 4:] = np.abs(sgs[:, 4:]) / energy.sum(0, keepdims=True) * 2.0 * np.pi * 0.8
    lobes = fibonacci_sphere(m // 2).astype(np.float32)
    sgs[:m // 2, :3] = lobes
    sgs[m // 2:, :3] = lobes
    if cfg.upper_hemi:
        sgs[:, 1] = np.abs(sgs[:, 1])
    return torch.from_numpy(sgs.astype(np.float32))


def restrict_lobes_upper(lgt_sgs: torch.Tensor) -> torch.Tensor:
    return torch.cat([lgt_sgs[..., :1], torch.abs(lgt_sgs[..., 1:2]),
                      lgt_sgs[..., 2:]], dim=-1)


def init_envmap_material(gen: torch.Generator, cfg: EnvmapMaterialConfig) -> Params:
    return {
        "brdf_encoder_layer": init_sparse_ae(gen, cfg.brdf_ae),
        "spec_brdf_encoder_layer": init_sparse_ae(gen, cfg.spec_brdf_ae),
        "normal_decoder_layer": init_sparse_ae(gen, cfg.normal_ae),
        "specular_reflectance": torch.full((1, 1), cfg.specular_albedo),
        "lgtSGs": init_lgt_sgs(gen, cfg),
    }


class MaterialOutput(NamedTuple):
    lgt_sgs: torch.Tensor
    specular_reflectance: torch.Tensor
    roughness: torch.Tensor
    metallic: torch.Tensor
    normal_map: torch.Tensor
    diffuse_albedo: torch.Tensor
    random_xi_roughness: torch.Tensor
    random_xi_metallic: torch.Tensor
    random_xi_diffuse_albedo: torch.Tensor
    random_xi_normal: torch.Tensor


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-4)


def envmap_material_apply(params: Params, cfg: EnvmapMaterialConfig,
                          points: torch.Tensor,
                          spec_noise: Optional[torch.Tensor] = None,
                          normal_noise: Optional[torch.Tensor] = None,
                          train_spec: bool = False,
                          spec_var: Optional[torch.Tensor] = None
                          ) -> MaterialOutput:
    """Forward (sg_envmap_material.py:188-247). ``spec_noise`` and
    ``normal_noise`` are the N(0,1) perturbations of the spec and normal
    heads' smoothness pairs (shapes ``cfg.spec_brdf_ae.noise_shape(N)`` and
    ``cfg.normal_ae.noise_shape(N)``; None disables them).
    ``train_spec=False`` detaches the BRDF head; ``spec_var`` is the CESR
    latent-dropout mask of the spec head."""
    pts_ipe = integrated_pos_enc(points, torch.full_like(points, 1e-5), cfg.ipe)
    pts_pe = positional_encoding(points, cfg.pe)

    brdf, brdf_xi = sparse_ae_apply(params["spec_brdf_encoder_layer"],
                                    cfg.spec_brdf_ae, pts_pe, spec_noise,
                                    var=spec_var)
    if not train_spec:
        brdf, brdf_xi = brdf.detach(), brdf_xi.detach()

    normal_map, xi_normal = sparse_ae_apply(params["normal_decoder_layer"],
                                            cfg.normal_ae, pts_ipe, normal_noise)
    lgt_sgs = params["lgtSGs"]
    if cfg.upper_hemi:
        lgt_sgs = restrict_lobes_upper(lgt_sgs)

    return MaterialOutput(
        lgt_sgs=lgt_sgs,
        specular_reflectance=params["specular_reflectance"],
        roughness=brdf[..., 3:4] * 0.9 + 0.09,
        metallic=brdf[..., 4:5] * 0.99 + 0.01,
        normal_map=_unit(normal_map),
        diffuse_albedo=brdf[..., :3],
        random_xi_roughness=brdf_xi[..., 3:4] * 0.9 + 0.09,
        random_xi_metallic=brdf_xi[..., 4:5],
        random_xi_diffuse_albedo=brdf_xi[..., :3],
        random_xi_normal=_unit(xi_normal))


def get_light(params: Params, cfg: EnvmapMaterialConfig) -> torch.Tensor:
    """The SG lights without a graph, restricted to the upper hemisphere
    where ``cfg.upper_hemi``."""
    lgt = params["lgtSGs"].detach()
    return restrict_lobes_upper(lgt) if cfg.upper_hemi else lgt


def load_light(params: Params, path: str) -> tuple[dict, np.ndarray]:
    """Prefit SGs and their envmap image for relighting
    (sg_envmap_material.py:257-268): ``<path>/sg_128.npy`` in place of
    ``lgtSGs`` (a new dict; ``params`` is left as it was) and the RGB of
    ``<path>.exr``. Returns (new params, envmap [H, W, 3])."""
    import os

    from ..utils.exr import read_exr

    sgs = np.load(os.path.join(path, "sg_128.npy"))
    new_params = dict(params)
    new_params["lgtSGs"] = torch.as_tensor(np.asarray(sgs, np.float32))
    return new_params, read_exr(path + ".exr")[..., :3]
