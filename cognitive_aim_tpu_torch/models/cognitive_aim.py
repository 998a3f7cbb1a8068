"""CognitiveAimModel — the full pipeline as an ``nn.Module`` (counterpart of
cognitive_aim_tpu/models/cognitive_aim.py).

``forward`` is the JAX package's ``apply``: the DINOv2 backbone in the
policy's compute dtype, its output cast to float32; curiosity (without
exif) and the ambient stream on the CLS token; the iterative focal stream
over the patch tokens in the compute dtype; the optional guided blend
(mask table 0.7 / attention 0.3, temperature-0.05 softmax, re-pool of the
float32 patch tokens); the EXIF prior; zero-padded fusion to 192; the
Softplus depth and Sigmoid confidence heads.

``attn_impl="pallas_packed"`` routes both attentions through the kernel
wrappers K1 (K7 under the token filter's proportional attention) and K6,
which launch the CUDA kernels for CUDA tensors and run their plain versions
for CPU tensors; ``"pallas_packed_i8qk"`` takes K10 and K10b, the int8-QK^T
attention, in the backbone; ``attn_impl="plain"`` and ``"plain_i8qk"`` run
the plain versions of those two routes on any device;
``attn_impl="pallas"`` is the backbone's ``[B, N, H, Dh]`` route through K8
(``"plain_heads"`` its plain version); the focal stream is fused on every
``pallas*`` route, as in the JAX package. Under the int8 policy (``policy.quantize_backbone``,
applied by ``prepare_params``) every backbone block is the chained int8
block (K2, K1, K3, K4) and each focal iteration projects through K5; with
live adapters (``arch.use_lora``) or exact GELU the blocks run unchained and
project q, k, v through K15 (nn/dinov2.py).

``arch.use_lora`` gives every backbone block the adapters of
``arch.lora_targets``; ``merge_lora_params`` folds them into the dense
weights (the deployment transform: fold, then ``prepare_params``).

With ``arch.token_filter_active`` the backbone runs the token filter
(nn/dinov2.py: drop mode, merge mode, the delta correction); a guided
request hands it the instruction's mask row as keep priority, so the guided
region's tokens stay in the kept set.

The model is built on the CUDA device unless the caller passes ``device``.

``forward(train=True)`` is the training forward the trainer differentiates
(train/trainer.py): dropout, the focal entropy, the curiosity KL weight of the
beta schedule, per-block recompute. A trainer keeps the float32 parameters
and never calls ``prepare_params``: the float backbone and focal stream cast
their weights to the compute dtype at each call, as the JAX package does.

``forward(pipeline_mesh=...)`` runs the backbone under the GPipe schedule
over the mesh's ``pipe`` axis (``DinoV2.apply_pipelined``); the streams,
fusion and heads run on every stage's copy of the output. It excludes the
token filter and the int8 backbone, with the JAX package's errors.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from cognitive_aim_tpu_torch.core.device import resolve_device
from cognitive_aim_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from cognitive_aim_tpu_torch.core.rng import NoiseMode, fold_in
from cognitive_aim_tpu_torch.models import curiosity as C
from cognitive_aim_tpu_torch.models import guidance as G
from cognitive_aim_tpu_torch.models import streams as S
from cognitive_aim_tpu_torch.models.config import ModelArchConfig
from cognitive_aim_tpu_torch.nn import dinov2
from cognitive_aim_tpu_torch.nn import init as tinit
from cognitive_aim_tpu_torch.nn import layers as L


@dataclasses.dataclass
class ModelOutput:
    depth: torch.Tensor  # [B, 1] Softplus, positive
    confidence: torch.Tensor  # [B, 1] Sigmoid
    attention: Optional[torch.Tensor]  # [B, N] per-patch attention, or None
    curiosity: torch.Tensor  # [B] curiosity reward
    fused_features: torch.Tensor  # [B, 192]
    aux: Dict[str, Any]


class CognitiveAimModel(nn.Module):
    def __init__(self, arch: ModelArchConfig, policy: Policy = DEFAULT_POLICY,
                 attn_impl: str = "pallas_packed",
                 vit_cfg: Optional[dinov2.DinoV2Config] = None, device=None):
        super().__init__()
        if attn_impl not in dinov2.ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {dinov2.ATTN_IMPLS}")
        device = resolve_device(device)
        self.arch = arch
        self.policy = policy
        self.attn_impl = attn_impl
        lora = dict(use_lora=arch.use_lora, lora_rank=arch.lora_rank,
                    lora_alpha=arch.lora_alpha, lora_targets=tuple(arch.lora_targets))
        self.vit_cfg = vit_cfg or dinov2.config_for(
            arch.backbone_size, gelu_approx=policy.fast_gelu, **lora)
        if vit_cfg is not None and arch.use_lora and not vit_cfg.use_lora:
            # an explicit vit_cfg must still honour the arch's adapter settings
            self.vit_cfg = dataclasses.replace(vit_cfg, **lora)
        D = self.feature_dim = self.vit_cfg.hidden_size
        a = arch
        self.backbone = dinov2.DinoV2(self.vit_cfg, device)
        if a.use_ambient:
            self.ambient_stream = S.AmbientStream(D, device=device)
        if a.use_focal:
            if a.use_iterative:
                self.focal_stream = S.IterativeFocalStream(
                    D, a.focal_hidden_dim, a.num_iterations, a.curiosity_guided, device)
                # persistent projection of the guided re-pool
                self.guided_projection = L.linear(D, 64, device)
            else:
                self.focal_stream = S.FocalStream(
                    D, a.focal_hidden_dim, 8, a.curiosity_guided, device)
        if a.use_exif:
            self.exif_prior = S.ExifPrior(a.num_cameras, device=device)
        if a.use_curiosity:
            self.curiosity_module = C.Curiosity(
                D, 256, a.enable_hierarchical_curiosity, device)
        self.fusion = L.MLP([a.fusion_dim, a.fusion_dim], device)
        self.decision_head = L.MLP([a.fusion_dim, 1], device)
        self.confidence_head = L.MLP([a.fusion_dim, 1, 1], device)
        self.exploration_history = C.ExplorationHistory()

    # ------------------------------------------------------------- init ----
    @torch.no_grad()
    def init(self, g: torch.Generator) -> "CognitiveAimModel":
        """Random weights with the JAX init's distributions, all drawn from
        ``g`` (which lives on the parameters' device)."""
        self.backbone.init(g)
        for name in ("ambient_stream", "focal_stream", "exif_prior", "curiosity_module"):
            if hasattr(self, name):
                getattr(self, name).init(g)
        if hasattr(self, "guided_projection"):
            tinit.linear_default_(self.guided_projection, g)
        self.fusion.init(g)
        # decision head: xavier_uniform gain 1.0, bias 1.0
        tinit.xavier_uniform_(self.decision_head.fc0.weight, 1.0, g)
        nn.init.ones_(self.decision_head.fc0.bias)
        # confidence head: torch defaults except the final bias = 2.0
        self.confidence_head.init(g)
        nn.init.constant_(self.confidence_head.fc1.bias, 2.0)
        return self

    @torch.no_grad()
    def merge_lora_params(self, rank: int = 0, alpha: int = 0) -> "CognitiveAimModel":
        """The deployment fold of adapter-gated weights: the backbone's
        adapters are merged into its dense weights and dropped, in place.
        ``rank`` and ``alpha`` default to the arch's settings; pass them where
        this model was built without ``use_lora``. Call before
        ``prepare_params``. A no-op when the backbone holds no adapters."""
        if not any(blk.has_adapters for blk in self.backbone.layers):
            return self
        r = rank or self.arch.lora_rank
        a = alpha or self.arch.lora_alpha
        if r <= 0:
            raise ValueError(f"merge_lora_params: the adapter rank resolved to {r} "
                             f"(alpha {a}); the scaling alpha / rank needs a positive rank")
        dinov2.merge_lora(self.backbone, a / r)
        return self

    @torch.no_grad()
    def prepare_params(self) -> "CognitiveAimModel":
        """Post-load transform for the policy: cast the backbone and focal
        stream parameters to the compute dtype once, in place. The JAX
        package casts them on every forward, to the same values; here that
        would cost a cast kernel per weight per forward. The position
        embeddings stay float32, since they are interpolated before the
        cast. Call once, after ``init``/``load_flat_params``, before serving.

        Under ``policy.quantize_backbone`` the backbone blocks' dense
        projections and a fused q/k/v projection per focal stream member
        are quantised to int8 from the float32 weights, before any cast;
        what the int8 kernels read in f32 (biases, layernorm parameters,
        LayerScales) keeps its compute-dtype rounding. Adapters stay float, in
        the compute dtype; a quantised block that holds live adapters runs
        unchained, a folded one chained again."""
        cd = self.policy.backbone_compute_dtype
        int8 = self.policy.quantize_backbone
        bb = self.backbone
        for blk in bb.layers:
            if int8:
                blk.quantize_(cd)
            else:
                blk.to(cd)
        for mod in (bb.patch_embed, bb.final_norm):
            mod.to(cd)
        bb.cls_token.data = bb.cls_token.data.to(cd)
        if hasattr(self, "focal_stream"):
            fs = self.focal_stream
            members = list(fs.streams) if self.arch.use_iterative else [fs]
            fused = [m.fused_qkv_int8(cd) for m in members] if int8 else []
            fs.to(cd)
            for m, qkv_i8 in zip(members, fused):
                m.qkv_i8 = qkv_i8
        return self

    # ---------------------------------------------------------- forward ----
    def forward(self, images: torch.Tensor,
                exif_data: Optional[Dict[str, torch.Tensor]] = None, *,
                guidance=None, generator: Optional[torch.Generator] = None,
                train: bool = False, noise_mode: NoiseMode = NoiseMode.SAMPLE,
                curiosity_kl_weight=None, pipeline_mesh=None, pipeline_n_micro: int = 4,
                precomputed_hs: Optional[torch.Tensor] = None) -> ModelOutput:
        """The JAX ``apply``. images: [B, H, W, 3] normalized NHWC. exif_data:
        dict of [B] tensors ('camera_idx' int; 'focal_length', 'aperture',
        'iso' float). guidance: None (unguided) or an instruction index in
        ``guidance.INSTRUCTIONS`` order, an int or a [B] tensor. Noise is
        drawn from ``generator`` (none: all draws 0).

        Differentiable: serving wraps it in ``torch.no_grad()``. ``train``
        turns on dropout (with a ``generator``), the focal attention entropy
        in ``aux["attention_entropy"]`` (0.0 at inference), per-block
        recompute of the backbone unless ``CAIM_TRAIN_REMAT`` is other than
        "1", and the token filter only where ``arch.token_filter_train``.
        Under ``train`` the curiosity, focal and dropout draws come from
        three streams folded out of ``generator``, as the JAX package folds
        three keys out of one; at inference the curiosity and focal draws
        share ``generator``. ``curiosity_kl_weight`` (a float or a 0-d
        tensor) replaces the KL weight 0.1. ``precomputed_hs`` [B, 1+N, D]
        replaces the backbone's output (``images`` still gives the guidance
        grid). ``pipeline_mesh``: run the backbone pipelined over that mesh's
        ``pipe`` axis in ``pipeline_n_micro`` microbatches of these rows."""
        a = self.arch
        if precomputed_hs is not None:
            hs = torch.as_tensor(precomputed_hs, dtype=torch.float32,
                                 device=self.decision_head.fc0.weight.device)
        elif pipeline_mesh is not None:
            kw = self.backbone_kwargs(images, guidance, train)
            if "filter_layer" in kw:
                raise ValueError(
                    "token filtering and pipeline parallelism are mutually "
                    "exclusive (the filter re-shapes the stream mid-stack)")
            if self.policy.quantize_backbone:
                raise ValueError(
                    "pipeline parallelism requires unquantized backbone "
                    "params (use policy='default'/'f32')")
            remat = train and os.environ.get("CAIM_TRAIN_REMAT", "1") == "1"
            hs = self.backbone.apply_pipelined(images, pipeline_mesh, n_micro=pipeline_n_micro,
                                               remat=remat, **kw).float()
        else:
            remat = train and os.environ.get("CAIM_TRAIN_REMAT", "1") == "1"
            hs = self.backbone(images, remat=remat,
                               **self.backbone_kwargs(images, guidance, train)).float()
        cls_token = hs[:, 0]
        patches = hs[:, 1:]
        B = patches.shape[0]
        aux: Dict[str, Any] = {}
        if train:
            g_cur, g_focal, g_drop = (fold_in(generator, i) for i in range(3))
        else:
            g_cur = g_focal = generator
            g_drop = None

        if a.use_curiosity:
            # exif is NOT passed: the geometric term sees it only in the loss
            reward, _, comps = C.curiosity_apply(
                self.curiosity_module, cls_token,
                kl_weight=0.1 if curiosity_kl_weight is None else curiosity_kl_weight,
                generator=g_cur, train=train, noise_mode=noise_mode)
            aux["curiosity_components"] = comps
        else:
            reward = torch.full((B,), 0.5, dtype=torch.float32, device=hs.device)

        raw_feats = []
        attention = None
        if a.use_ambient:
            raw_feats.append(S.ambient_apply(self.ambient_stream, cls_token,
                                             generator=g_drop, train=train))
        if a.use_focal:
            focal_feats, attention, aux["attention_entropy"] = self._focal(
                patches, reward, guidance, g_focal, noise_mode, train)
            raw_feats.append(focal_feats.float())
            attention = attention.float()
        if a.use_exif and exif_data is not None:
            raw_feats.append(S.exif_prior_apply(self.exif_prior, exif_data,
                                                generator=g_drop, train=train))
        if not raw_feats:
            raise RuntimeError("Cognitive modules returned no features!")
        concat = torch.cat(raw_feats, dim=1)
        if concat.shape[1] < a.fusion_dim:  # zero-pad
            concat = F.pad(concat, (0, a.fusion_dim - concat.shape[1]))

        fused = L.mlp_apply(self.fusion, concat, final_act=F.relu)
        if train and generator is not None:
            fused = L.dropout(fused, 0.1, fold_in(generator, 99))
        depth = L.mlp_apply(self.decision_head, fused, final_act=F.softplus)
        confidence = L.mlp_apply(self.confidence_head, fused, final_act=torch.sigmoid)
        return ModelOutput(depth=depth, confidence=confidence, attention=attention,
                           curiosity=reward, fused_features=fused, aux=aux)

    def backbone_kwargs(self, images: torch.Tensor, guidance=None,
                        train: bool = False) -> Dict[str, Any]:
        """Keyword arguments of the backbone call for this request: compute
        dtype, attention route and, with the token filter active (in
        training only where ``arch.token_filter_train``), its settings and
        the guidance mask row as ``keep_weights`` (guided-region tokens get
        keep priority, so the focal re-pool sees fresh features where the
        instruction points)."""
        a = self.arch
        kw: Dict[str, Any] = dict(compute_dtype=self.policy.backbone_compute_dtype,
                                  attn_impl=self.attn_impl)
        if not a.token_filter_active or (train and not a.token_filter_train):
            return kw
        kw.update(
            filter_layer=a.token_filter_layer,
            filter_keep=a.token_filter_keep,
            filter_fuse=a.token_filter_fuse,
            filter_fuse_k=a.token_filter_fuse_k,
            filter_schedule=a.token_filter_schedule,
            filter_rollout=a.token_filter_rollout,
            filter_merge=a.token_filter_merge,
            filter_delta_correct=a.token_filter_delta_correct,
            filter_strat_stride=a.token_filter_strat_stride,
            filter_prop_attn=a.token_filter_prop_attn,
            filter_ctx_frac=a.token_filter_ctx_frac,
        )
        if guidance is not None:
            B = images.shape[0]
            p = self.vit_cfg.patch_size
            gh, gw = images.shape[1] // p, images.shape[2] // p
            g_idx = torch.as_tensor(guidance, dtype=torch.long, device=images.device)
            gvec = G.mask_table(gh, gh * gw, images.device)[g_idx]
            if gvec.ndim == 1:
                gvec = gvec[None].expand(B, gh * gw)
            kw["keep_weights"] = gvec
        return kw

    def _focal(self, patches, curiosity_score, guidance, generator, noise_mode,
               train=False):
        a = self.arch
        run = patches.to(self.policy.backbone_compute_dtype)
        kw = dict(curiosity_guided=a.curiosity_guided, generator=generator,
                  train=train, noise_mode=noise_mode,
                  fused_attention=self.attn_impl.startswith("pallas"))
        if a.use_iterative:
            feats, attn, entropy = S.iterative_focal_apply(
                self.focal_stream, run, curiosity_score,
                focus_strength=a.focus_strength, **kw)
        else:
            feats, attn, entropy = S.focal_apply(self.focal_stream, run, curiosity_score,
                                                 **kw)
        if guidance is None:
            return feats, attn, entropy

        # guided blend: 0.7 * mask + 0.3 * attention, temperature-0.05
        # softmax, re-pool of the float32 patch tokens
        N = patches.shape[1]
        g_idx = torch.as_tensor(guidance, dtype=torch.long, device=patches.device)
        gvec = G.mask_table(int(N ** 0.5), N, patches.device)[g_idx]
        if gvec.ndim == 1:
            gvec = gvec[None]
        guided = torch.softmax((0.7 * gvec + 0.3 * attn) / 0.05, dim=-1)
        weighted = (patches * guided[..., None]).sum(dim=1)
        if a.use_iterative:
            gfeats = L.linear_apply(self.guided_projection, weighted)
        else:
            gfeats = L.mlp_apply(self.focal_stream.projection, weighted, dropout_rate=0.1,
                                 dropout_after=(0,), generator=generator, train=train)
        return gfeats, guided, entropy

    # --------------------------------------------------------- training ----
    def compute_curiosity_loss(self, features, exif_data=None, *, loss_type="robust",
                               uncertainty_weight=0.1, kl_weight=0.1, generator=None,
                               noise_mode=NoiseMode.SAMPLE):
        """Curiosity over given features WITH exif (the geometric term
        active); ``kl_weight`` takes the trainer's beta schedule. Returns
        (reward [B], components)."""
        reward, _, comps = C.curiosity_apply(
            self.curiosity_module, features, exif_data, loss_type=loss_type,
            uncertainty_weight=uncertainty_weight, kl_weight=kl_weight,
            generator=generator, noise_mode=noise_mode)
        return reward, comps

    def get_exploration_stats(self):
        return self.exploration_history.statistics()

    def record_exploration(self, rewards):
        self.exploration_history.update(rewards)
