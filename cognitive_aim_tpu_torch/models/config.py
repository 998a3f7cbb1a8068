"""Config system: one typed resolver that accepts the shipped YAMLs verbatim.

This package's own copy of cognitive_aim_tpu/models/config.py (plain Python,
no array library), so that nothing here imports the JAX package;
tests/test_torch_model.py holds the dataclass fields, the defaults and the
token-filter functions equal to the original's.

The reference has *two half-schemas* (SURVEY.md §5): the YAMLs nest most
hyperparameters under `model:`, but `CognitiveAimModel.__init__` reads them
from the TOP level with defaults (ref:src/model.py:803 `backbone_size`,
:817 `freeze_backbone` default True, :822 `use_lora` default False,
:854 `curiosity_guided_attention.enabled` — note the key is 'enabled' while
every YAML writes 'enable', so it is ALWAYS False in the reference —
:855/:860-862 `focal_config` with defaults num_iterations=3,
focus_strength=1.5). Only `cognitive_modules` gets the two-level lookup
(ref:src/model.py:834-836). Consequence: for every shipped YAML the reference
instantiates the *defaults* (frozen base backbone, no active LoRA,
3-iteration focal, no curiosity-guided attention).

`resolve_model_config(raw, lookup=...)` supports:
  * "reference" (default): byte-faithful reproduction of those lookups, so a
    given YAML yields the same architecture the reference would build;
  * "nested": additionally falls back to `model.*` for each key — what the
    YAML authors evidently intended (6-iteration focal etc.).

Extension over the reference: the eval_configs' ablation toggles
(`model.enable_ambient_stream` / `enable_focal_stream` / `enable_exif_prior`
/ `enable_curiosity_driven`) are read by NO reference code (dead config
surface). Here they are honored by default (`honor_ablation_toggles=True`)
so the ablation sweep in BASELINE.json is actually an ablation; pass False
for strict reference behavior.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class ModelArchConfig:
    backbone_size: str = "base"
    freeze_backbone: bool = True
    use_lora: bool = False
    lora_rank: int = 16
    lora_alpha: int = 16
    # adapter targets in the backbone blocks. ("attn_out",) = the
    # reference's LoRALayer shape; the adapter-gated filter sandwich uses
    # ("qkv", "attn_out", "fc1", "fc2") — see nn/dinov2.py.
    lora_targets: tuple = ("attn_out",)
    use_ambient: bool = True
    use_focal: bool = True
    use_iterative: bool = True
    use_exif: bool = True
    use_curiosity: bool = True
    num_iterations: int = 3
    focus_strength: float = 1.5
    focal_hidden_dim: int = 256
    curiosity_guided: bool = False
    attention_dropout: float = 0.1  # recorded; FocalStream hardcodes p=0 (ref:70)
    enable_hierarchical_curiosity: bool = True
    num_cameras: int = 71
    image_size: int = 224
    # Opt-in approximate fast path (NOT reference behavior; off by default):
    # after `token_filter_layer` full blocks, keep only the top
    # `token_filter_keep` fraction of patch tokens (ranked by next-layer CLS
    # attention + guidance-region priority) through the remaining blocks.
    # Inference-only; see nn/dinov2.py and docs/PERF.md.
    token_filter_layer: int = 0
    token_filter_keep: float = 1.0
    token_filter_fuse: bool = True  # EViT-style fused context token
    # Number of fused context tokens ('@fN' suffix; perfect square). At
    # k>1 the patch grid splits into sqrt(k) x sqrt(k) cells and each
    # context token aggregates its cell's dropped tokens — regional means
    # survive the drop. Drop mode only.
    token_filter_fuse_k: int = 1
    # Progressive variant: ((layer, keep), ...) — several smaller drops
    # instead of one cliff; overrides the single layer/keep pair. Parsed
    # from 'L1:K1,L2:K2,...' CLI specs by parse_token_filter.
    token_filter_schedule: tuple = ()
    # 0..1: blend carried importance from earlier stages into later-stage
    # ranking (multi-layer rollout evidence); '@rX' suffix in CLI specs.
    token_filter_rollout: float = 0.0
    # Merge mode ('@m' suffix): dropped tokens are absorbed into their
    # most-similar kept token (ToMe-style) instead of frozen, and dropped
    # positions read their representative's final-layer feature at
    # un-filter time. Tighter prediction parity at ~equal throughput.
    token_filter_merge: bool = False
    # Delta-corrected drop mode ('@d'): drop-mode backbone, but dropped
    # positions get their nearest kept neighbour's accumulated residual
    # update added at un-filter time. Single-stage only.
    token_filter_delta_correct: bool = False
    # Stratified keep ('@sN'): reserve an (N,N)-strided spatial grid of
    # tokens (priority above background, below guided tiers) so the kept
    # set stays a spatially unbiased sample. 0 = off.
    token_filter_strat_stride: int = 0
    # Proportional attention ('@p'): in post-filter blocks, tokens that
    # represent several source tokens (fused context tokens in drop mode,
    # merged kept tokens in '@m') get a +log(#represented) attention-logit
    # bias, so the softmax assigns them their sources' aggregate mass
    # instead of renormalizing all mass onto the kept subsample — the
    # measured CLS-row drift mechanism (docs/PERF.md round-4 section).
    token_filter_prop_attn: bool = False
    # Context reserve ('@cF', 0 <= F < 1): reserve fraction F of the keep
    # budget for the top tokens by RAW CLS importance, bypassing the
    # guidance boost. Exact no-op unguided; under guidance it guarantees
    # scene context survives even when the boosted guided tiers alone
    # would exhaust the budget (nn/dinov2.py:_keep_indices).
    token_filter_ctx_frac: float = 0.0
    # Keep the filter active during TRAINING too (filter-aware finetuning,
    # the EViT deployment recipe). Off by default: training stays exact.
    token_filter_train: bool = False

    @property
    def token_filter_active(self) -> bool:
        return bool(self.token_filter_schedule) or (
            self.token_filter_layer > 0 and self.token_filter_keep < 1.0
        )

    @property
    def feature_dim(self) -> int:
        return 1024 if self.backbone_size == "large" else 768

    @property
    def fusion_dim(self) -> int:
        return 192  # hardcoded checkpoint fusion dim (ref:src/model.py:904)

    @property
    def n_streams(self) -> int:
        return int(self.use_ambient) + int(self.use_focal) + int(self.use_exif)


def _get(raw: Mapping, key: str, default, lookup: str):
    """reference: top-level only; nested: top-level, then model.*"""
    if key in raw:
        return raw[key]
    if lookup == "nested" and key in raw.get("model", {}):
        return raw["model"][key]
    return default


def resolve_num_cameras(raw: Mapping, default: int = 71) -> int:
    """demo.py's resolution order (ref:demo.py:57-65)."""
    if "exif_config" in raw:
        return raw["exif_config"].get("num_cameras", default)
    if "exif_config" in raw.get("model", {}):
        return raw["model"]["exif_config"].get("num_cameras", default)
    return default


def resolve_image_size(raw: Mapping, default: int = 224) -> int:
    """ref:demo.py:154-160: int / [s] / [h, w] all accepted."""
    size = raw.get("dataset", {}).get("image_size", default)
    if isinstance(size, int):
        return size
    if isinstance(size, Sequence):
        return int(size[0])
    return default


def parse_token_filter(spec: str) -> dict:
    """CLI spec -> token-filter config kwargs (empty spec -> {}).

    'LAYER:KEEP'                -> single-stage filter
    'L1:K1,L2:K2,...'           -> progressive schedule (strictly
                                   increasing layers, decreasing keeps)
    '...@rX'                    -> with importance rollout weight X
    '...@m'                     -> merge mode (ToMe-style absorb instead
                                   of drop; options compose, e.g. '@m@r0.5')
    '...@d'                     -> delta-corrected drop (residual-update
                                   transplant at un-filter; single-stage)
    '...@sN'                    -> stratified keep: reserve an (N,N)-
                                   strided spatial grid in the kept set
    '...@fN'                    -> N fused context tokens (perfect
                                   square), one per spatial cell
    '...@p'                     -> proportional attention: fused/merged
                                   tokens get +log(#represented) logit
                                   bias in post-filter blocks
    '...@cF'                    -> context reserve: fraction F of the keep
                                   budget goes to top RAW-importance
                                   tokens, bypassing the guidance boost
    Single parse point for api.py / bench.py / scripts/policy_delta.py."""
    if not spec:
        return {}
    out = {}
    parts = spec.split("@")
    spec = parts[0]
    for opt in parts[1:]:
        if opt == "m":
            out["token_filter_merge"] = True
        elif opt == "d":
            out["token_filter_delta_correct"] = True
        elif opt.startswith("s"):
            out["token_filter_strat_stride"] = int(opt[1:])
        elif opt == "p":
            out["token_filter_prop_attn"] = True
        elif opt.startswith("c"):
            out["token_filter_ctx_frac"] = float(opt[1:])
        elif opt.startswith("f"):
            out["token_filter_fuse_k"] = int(opt[1:])
        elif opt.startswith("r"):
            out["token_filter_rollout"] = float(opt[1:])
        else:
            raise ValueError(f"unknown token-filter option '@{opt}'")
    stages = []
    for part in spec.split(","):
        layer, keep = part.split(":")
        stages.append((int(layer), float(keep)))
    if len(stages) == 1:
        out.update(token_filter_layer=stages[0][0],
                   token_filter_keep=stages[0][1])
    else:
        out["token_filter_schedule"] = tuple(stages)
    return out


def token_filter_spec(arch) -> str:
    """Inverse of parse_token_filter for the fields it sets: canonical
    'L:K[,L2:K2][@opts]' string of an arch's token-filter config, '' when
    no filter is active. Used for checkpoint provenance stamps (the fast
    configs are certified RECIPE-CONDITIONALLY — only with weights
    trained/sandwiched for the spec — so loaders compare this string
    against the stamp the trainer wrote; docs/PERF.md round-4/5)."""
    stages = tuple(arch.token_filter_schedule or ())
    if not stages and 0 < arch.token_filter_layer \
            and 0.0 < arch.token_filter_keep < 1.0:
        stages = ((arch.token_filter_layer, arch.token_filter_keep),)
    if not stages:
        return ""
    s = ",".join(f"{int(l)}:{float(k):g}" for l, k in stages)
    if getattr(arch, "token_filter_merge", False):
        s += "@m"
    if getattr(arch, "token_filter_delta_correct", False):
        s += "@d"
    if getattr(arch, "token_filter_strat_stride", 0):
        s += f"@s{arch.token_filter_strat_stride}"
    if getattr(arch, "token_filter_prop_attn", False):
        s += "@p"
    if getattr(arch, "token_filter_ctx_frac", 0.0):
        s += f"@c{arch.token_filter_ctx_frac:g}"
    if getattr(arch, "token_filter_fuse_k", 1) > 1:
        s += f"@f{arch.token_filter_fuse_k}"
    if getattr(arch, "token_filter_rollout", 0.0):
        s += f"@r{arch.token_filter_rollout:g}"
    return s


DEFAULT_COGNITIVE_MODULES = (
    # demo.py's injected default (ref:demo.py:48-52)
    "ambient_stream",
    "iterative_focal_stream",
    "exif_prior_database",
)


def resolve_model_config(
    raw: Mapping[str, Any],
    camera_info: Optional[Mapping] = None,
    *,
    lookup: str = "reference",
    honor_ablation_toggles: bool = True,
    inject_default_modules: bool = True,
) -> ModelArchConfig:
    model_cfg = raw.get("model", {})
    modules = list(
        model_cfg.get("cognitive_modules", raw.get("cognitive_modules", []))
    )
    if not modules and inject_default_modules:
        modules = list(DEFAULT_COGNITIVE_MODULES)

    use_ambient = "ambient_stream" in modules
    use_iterative = "iterative_focal_stream" in modules
    use_focal = use_iterative or ("focal_stream" in modules)

    camera_given = camera_info is not None or "exif_prior_database" not in modules
    if camera_info is None:
        # demo.py builds camera_info whenever the module is listed
        # (ref:demo.py:57-65); default when caller passes none.
        num_cameras = resolve_num_cameras(raw)
        camera_given = True
    else:
        num_cameras = int(camera_info.get("num_cameras", 71))
    use_exif = ("exif_prior_database" in modules) and camera_given

    use_curiosity = True  # always constructed (ref:src/model.py:948-953)
    use_lora = bool(_get(raw, "use_lora", False, lookup))
    freeze = bool(_get(raw, "freeze_backbone", True, lookup))

    cga = _get(raw, "curiosity_guided_attention", {}, lookup) or {}
    if lookup == "reference":
        curiosity_guided = bool(cga.get("enabled", False))  # ref:854 typo kept
    else:
        curiosity_guided = bool(cga.get("enabled", cga.get("enable", False)))

    focal_cfg = _get(raw, "focal_config", {}, lookup) or {}

    if honor_ablation_toggles:
        mt = model_cfg
        if "enable_ambient_stream" in mt:
            use_ambient = use_ambient and bool(mt["enable_ambient_stream"])
        if "enable_focal_stream" in mt:
            focal_on = bool(mt["enable_focal_stream"])
            use_focal = use_focal and focal_on
            use_iterative = use_iterative and focal_on
        if "enable_exif_prior" in mt:
            use_exif = use_exif and bool(mt["enable_exif_prior"])
        if "enable_curiosity_driven" in mt:
            use_curiosity = bool(mt["enable_curiosity_driven"])
        if "use_lora" in mt and lookup == "nested":
            use_lora = bool(mt["use_lora"])

    return ModelArchConfig(
        backbone_size=str(_get(raw, "backbone_size", "base", lookup)),
        freeze_backbone=freeze,
        use_lora=use_lora,
        lora_rank=int(_get(raw, "lora_rank", 16, lookup)),
        lora_alpha=int(_get(raw, "lora_alpha", 16, lookup)),
        lora_targets=tuple(
            _get(raw, "lora_targets", ("attn_out",), lookup) or ("attn_out",)),
        use_ambient=use_ambient,
        use_focal=use_focal,
        use_iterative=use_iterative,
        use_exif=use_exif,
        use_curiosity=use_curiosity,
        num_iterations=int(focal_cfg.get("num_iterations", 3)),
        focus_strength=float(focal_cfg.get("focus_strength", 1.5)),
        focal_hidden_dim=int(_get(raw, "focal_hidden_dim", 256, lookup)),
        curiosity_guided=curiosity_guided,
        attention_dropout=float(cga.get("attention_dropout", 0.1)),
        enable_hierarchical_curiosity=bool(
            _get(raw, "enable_hierarchical_curiosity", True, lookup)
        ),
        num_cameras=num_cameras,
        image_size=resolve_image_size(raw),
        # new config surface (no reference equivalent): accepted at top
        # level or under model.* regardless of lookup mode
        token_filter_layer=int(
            _get(raw, "token_filter_layer",
                 model_cfg.get("token_filter_layer", 0), lookup)
        ),
        token_filter_keep=float(
            _get(raw, "token_filter_keep",
                 model_cfg.get("token_filter_keep", 1.0), lookup)
        ),
        token_filter_fuse=bool(
            _get(raw, "token_filter_fuse",
                 model_cfg.get("token_filter_fuse", True), lookup)
        ),
        token_filter_fuse_k=int(
            _get(raw, "token_filter_fuse_k",
                 model_cfg.get("token_filter_fuse_k", 1), lookup)
        ),
        token_filter_schedule=tuple(
            (int(l), float(k)) for l, k in
            _get(raw, "token_filter_schedule",
                 model_cfg.get("token_filter_schedule", ()), lookup)
        ),
        token_filter_rollout=float(
            _get(raw, "token_filter_rollout",
                 model_cfg.get("token_filter_rollout", 0.0), lookup)
        ),
        token_filter_merge=bool(
            _get(raw, "token_filter_merge",
                 model_cfg.get("token_filter_merge", False), lookup)
        ),
        token_filter_delta_correct=bool(
            _get(raw, "token_filter_delta_correct",
                 model_cfg.get("token_filter_delta_correct", False), lookup)
        ),
        token_filter_strat_stride=int(
            _get(raw, "token_filter_strat_stride",
                 model_cfg.get("token_filter_strat_stride", 0), lookup)
        ),
        token_filter_prop_attn=bool(
            _get(raw, "token_filter_prop_attn",
                 model_cfg.get("token_filter_prop_attn", False), lookup)
        ),
        token_filter_ctx_frac=float(
            _get(raw, "token_filter_ctx_frac",
                 model_cfg.get("token_filter_ctx_frac", 0.0), lookup)
        ),
        token_filter_train=bool(
            _get(raw, "token_filter_train",
                 model_cfg.get("token_filter_train", False), lookup)
        ),
    )
