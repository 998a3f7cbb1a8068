"""Inference engine: ``CognitiveAimInference`` (counterpart of
cognitive_aim_tpu/api.py), the surface that demo_torch.py, the HTTP server
and the nine-grid tool call.

The engine keeps its parameters in two forms:

  * ``params``: the flat float32 interchange (``convert.flat_params``), the
    JAX package's ``flatten_tree`` keys. Checkpoints merge into it,
    ``save_native_checkpoint`` writes it, and assigning to ``params``
    rebuilds the model from it;
  * ``model``: a ``CognitiveAimModel`` loaded from ``params`` and then
    prepared for the policy (cast, and under ``int8`` quantised, in place).

The constructor runs: build -> init from ``torch.Generator(device)
.manual_seed(seed)`` -> ``load_checkpoint`` -> keep the flat float32
interchange -> fold adapters -> ``prepare_params``. Forwards run under
``torch.no_grad()``; outputs reach the host only where the JAX engine calls
``np.asarray``. The engine builds on the CUDA device unless the caller
passes ``device="cpu"`` (``"auto"`` is the card, and raises without one).

Decided differently from the JAX engine (both are reference faults):

  * a filtered engine given LoRA tensors with no ``adapter_rank`` stamp,
    which it cannot load as live adapters, raises ``CheckpointRefused``
    naming the missing stamp; the JAX engine skips the fold and serves the
    base weights. Exact engines still drop the adapter tensors;
  * the ``train_filter`` stamp is compared after canonicalisation
    (``token_filter_spec(parse_token_filter(stamp))``), so a raw CLI
    string such as ``2:0.35`` matches its canonical spec;

and ``CheckpointRefused`` (those two refusals, and the stamp check under
``CAIM_REQUIRE_FILTER_STAMP=1``) propagates out of ``load_checkpoint``
where the JAX engine's catch-all turns it into random weights.

``save_native_checkpoint`` writes the float32 interchange under every
policy: the port's int8 blocks hold one fused q/k/v weight, not the JAX
prepared tree's separate and fused int8 forms, and the float32 file reloads
to the same model bit for bit.

``noise_mode="sample"`` draws from a fresh ``torch.Generator`` per call
(``_next_key``); it cannot equal JAX's streams, so parity uses ``"zeros"``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cognitive_aim_tpu_torch.convert import flat_params, load_flat_params
from cognitive_aim_tpu_torch.core.device import resolve_device
from cognitive_aim_tpu_torch.core.precision import policy_from_name
from cognitive_aim_tpu_torch.core.rng import NoiseMode
from cognitive_aim_tpu_torch.io import checkpoint_torch as ct
from cognitive_aim_tpu_torch.io import exif as exif_io
from cognitive_aim_tpu_torch.io.preprocess import (
    load_image_uint8,
    normalize_np,
    normalize_u8,
    pil_resize_host,
)
from cognitive_aim_tpu_torch.models import guidance as G
from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
from cognitive_aim_tpu_torch.models.config import (
    ModelArchConfig,
    parse_token_filter,
    resolve_model_config,
    token_filter_spec,
)

_LORA = "backbone/layers/lora"
_FILTERPATH = "filterpath/"


class CheckpointRefused(ValueError):
    """A checkpoint this engine refuses to serve; ``load_checkpoint`` lets
    it propagate instead of continuing on random weights."""


def load_config(path: str) -> dict:
    """``yaml.safe_load``, as the JAX engine reads its config; without
    PyYAML, ``json.load`` (a JSON file is YAML, so both read it)."""
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        try:
            return json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}: PyYAML is not installed and the file is not "
                             f"JSON ({e}); install PyYAML or pass a JSON config") from None
    return yaml.safe_load(text)


def _canonical_filter(stamp: str) -> str:
    try:
        return token_filter_spec(ModelArchConfig(**parse_token_filter(stamp)))
    except (ValueError, TypeError):
        return stamp  # unparseable: compared as written, so it mismatches


class CognitiveAimInference:
    def __init__(
        self,
        config_path: str,
        checkpoint_path: Optional[str] = None,
        device: str = "auto",
        *,
        lookup: str = "reference",
        policy: str = "default",
        attn_impl: str = "pallas_packed",
        seed: int = 0,
        noise_mode: str = "sample",
        save_images: bool = True,
        output_dir: str = "demo_results",
        vit_cfg=None,  # testing hook: override the backbone size
        token_filter: str = "",  # "LAYER:KEEP" opt-in approximate fast path
    ):
        self.config = load_config(config_path)
        if token_filter:
            self.config.update(parse_token_filter(token_filter))

        # demo.py's default module injection
        if "cognitive_modules" not in self.config and \
                "cognitive_modules" not in self.config.get("model", {}):
            self.config["cognitive_modules"] = [
                "ambient_stream",
                "iterative_focal_stream",
                "exif_prior_database",
            ]

        self.arch = resolve_model_config(self.config, lookup=lookup)
        self.device = resolve_device(None if device in (None, "auto") else device)
        self.policy = policy_from_name(policy)
        self.attn_impl = attn_impl
        self.vit_cfg = vit_cfg
        self.noise_mode = NoiseMode(noise_mode)
        self.save_images = save_images
        self.output_dir = output_dir
        self.image_size = self.arch.image_size
        self.camera_to_id = {"unknown": 0}
        self.seed = seed
        self._draws = 0
        self._rng_lock = threading.Lock()
        # batch sizes of the forwards run, and the host decoder of the last
        # predict_paths_batched ('native' or 'pil')
        self.batch_sizes: collections.Counter = collections.Counter()
        self.last_decoder: Optional[str] = None

        self._params = flat_params(
            self._new_model().init(torch.Generator(self.device).manual_seed(seed)))
        self.model: Optional[CognitiveAimModel] = None
        if checkpoint_path:
            self.load_checkpoint(checkpoint_path)
        if self.model is None:
            self._materialize()

    # ----------------------------------------------------------- params ----
    @property
    def params(self) -> Dict[str, np.ndarray]:
        """The flat float32 interchange the model was built from."""
        return self._params

    @params.setter
    def params(self, flat: Dict[str, np.ndarray]):
        self._materialize(flat)

    def _new_model(self) -> CognitiveAimModel:
        return CognitiveAimModel(self.arch, policy=self.policy, attn_impl=self.attn_impl,
                                 vit_cfg=self.vit_cfg, device=self.device)

    def _materialize(self, params: Optional[Dict[str, np.ndarray]] = None,
                     adapters: Optional[Dict[str, np.ndarray]] = None,
                     fold: Tuple[int, int] = (0, 0)):
        """Build the model from ``params`` (default: the current ones) and
        prepare it for the policy; with ``adapters``, first fold them at
        ``(rank, alpha)`` into the dense weights of a float32 model loaded
        with ``load_flat_params`` and ``merge_lora_params``, and take the
        folded weights as the new ``params``. Commits only on success."""
        params = dict(self._params if params is None else params)
        if adapters:
            folded = load_flat_params(self._new_model(), {**params, **adapters})
            params.update(flat_params(folded.merge_lora_params(*fold)))
            del folded  # free its weights before the next model is built
        model = load_flat_params(self._new_model(), params)
        model.prepare_params()
        if self.model is not None:  # the exploration record outlives a reload
            model.exploration_history = self.model.exploration_history
        self._params, self.model = params, model

    # -------------------------------------------------------- checkpoint ----
    def load_checkpoint(self, path: str):
        """Tolerant loading: torch containers (model_state_dict / main_model /
        raw) with shape filtering, or a native .npz flat interchange, a
        trainer's checkpoint included (``trainer_params``). Continues on the weights it has if the file cannot be read; a
        ``CheckpointRefused`` propagates."""
        try:
            fold, adapters = (0, 0), None
            if path.endswith((".npz", ".npy")):
                with np.load(path) as z:
                    meta = npz_meta(z)
                    self._check_filter_stamp(meta, path)
                    incoming = trainer_params(unflatten_npz(z))
                incoming, adapters, fold = self._maybe_merge_adapters(incoming, meta)
            else:
                sd = ct.load_torch_file(path)
                # torch checkpoints carry no provenance stamp
                self._check_filter_stamp({}, path)
                incoming = self._convert_state_dict(sd)
            merged, loaded, skipped = ct.filter_and_merge(self._params, incoming)
            self._materialize(merged, adapters, fold)
            print(f"Loaded checkpoint {path}: {loaded} tensors, {skipped} skipped")
        except CheckpointRefused:
            raise
        except Exception as e:  # the reference keeps its weights on failure
            print(f"Error loading checkpoint: {e}")
            print("Continuing with randomly initialized weights...")

    def _check_filter_stamp(self, meta: Dict[str, str], path: str):
        """The token-filter fast configs are certified only with weights
        trained or sandwiched for the spec. If this engine runs a filter but
        the checkpoint's ``__meta__/train_filter`` stamp does not name the
        same spec (after canonicalisation), warn, or refuse when
        CAIM_REQUIRE_FILTER_STAMP=1."""
        spec = token_filter_spec(self.arch)
        if not spec:
            return
        stamp = meta.get("train_filter", "")
        if stamp and _canonical_filter(stamp) == spec:
            return
        detail = (f"stamped for '{stamp}'" if stamp
                  else "carries no train-filter stamp")
        msg = (f"token filter '{spec}' is active but checkpoint {path} "
               f"{detail}. The filter's parity certification is "
               f"recipe-conditional: on weights not trained for the spec "
               f"the guided filter is REFUTED (worst-instruction gt-gap "
               f"up to 78%, docs/PERF.md). Train/sandwich for the spec "
               f"or drop token_filter_* from the config.")
        if os.environ.get("CAIM_REQUIRE_FILTER_STAMP", "") == "1":
            raise CheckpointRefused(msg)
        print(f"WARNING: {msg}")

    def _maybe_merge_adapters(self, incoming: Dict, meta: Dict[str, str]):
        """The deployment fold of adapter-gated sandwich checkpoints. A
        filtered engine takes the ``filterpath/`` head overlay (whole
        top-level subtrees replaced); an exact engine strips it. When this
        engine runs a token filter and the checkpoint carries backbone LoRA
        tensors stamped with ``adapter_rank``, they are folded into the
        dense weights: returns (incoming without the adapters, the
        adapters, (rank, alpha)) for ``_materialize``, which loads them with
        ``load_flat_params`` and folds with ``merge_lora_params`` before
        ``prepare_params``. Without a stamp it refuses where the adapters
        could not load as this engine's own live adapters."""
        filtered = bool(token_filter_spec(self.arch))
        out = {k: v for k, v in incoming.items() if not k.startswith(_FILTERPATH)}
        fp = {k[len(_FILTERPATH):]: v for k, v in incoming.items()
              if k.startswith(_FILTERPATH)}
        if fp and filtered:
            # sandwich head deltas: the filtered path serves heads/streams
            # trained against filtered feature statistics
            tops = {k.split("/")[0] for k in fp}
            out = {k: v for k, v in out.items() if k.split("/")[0] not in tops}
            out.update(fp)
            print(f"Applied filterpath overlay ({len(tops)} subtrees: "
                  f"path-gated sandwich head deltas)")
        lora = {k: v for k, v in out.items() if k.startswith(_LORA)}
        if not lora or not filtered:
            return out, None, (0, 0)
        rank = int(meta.get("adapter_rank", "0") or 0)
        alpha = int(meta.get("adapter_alpha", str(rank)) or rank)
        if rank <= 0:
            dropped = sorted(k for k, v in lora.items()
                             if np.shape(self._params.get(k)) != np.shape(v))
            if dropped:
                raise CheckpointRefused(
                    f"checkpoint holds backbone adapters ({', '.join(dropped)}) but no "
                    f"'__meta__/adapter_rank' stamp: the filtered engine cannot fold them "
                    f"and would serve the base weights; stamp adapter_rank (and "
                    f"adapter_alpha) or load it in an exact engine")
            return out, None, (0, 0)
        print(f"Folded rank-{rank} filter adapters into backbone weights "
              f"(targets {meta.get('adapter_targets', '?')})")
        return ({k: v for k, v in out.items() if k not in lora}, lora, (rank, alpha))

    def _convert_state_dict(self, sd) -> Dict[str, np.ndarray]:
        a = self.arch
        out: Dict[str, np.ndarray] = {}

        def take(prefix, fn):
            try:
                flat = fn()
            except KeyError:
                return
            out.update({f"{prefix}{k}": v for k, v in flat.items()})

        take("backbone/", lambda: ct.convert_backbone(sd, "backbone."))
        cvt = {
            "ambient_stream": (a.use_ambient, lambda: ct.convert_ambient(sd)),
            "focal_stream": (
                a.use_focal,
                lambda: ct.convert_iterative_focal(sd)
                if a.use_iterative
                else ct.convert_focal_stream(sd, "focal_stream"),
            ),
            "exif_prior": (a.use_exif, lambda: ct.convert_exif_prior(sd)),
            "curiosity_module": (a.use_curiosity, lambda: ct.convert_curiosity(sd)),
        }
        for name, (enabled, fn) in cvt.items():
            if enabled:
                take(f"{name}/", fn)
        take("", lambda: ct.convert_heads(sd))
        return out

    def save_native_checkpoint(self, path: str):
        np.savez(path, **self._params)

    # ---------------------------------------------------------- predict ----
    def _next_key(self) -> torch.Generator:
        """A fresh generator on the model's device for one forward, seeded
        from ``seed`` and a counter. The lock: the HTTP server calls this
        from its dispatcher thread and from request handler threads, and
        two callers must never share one noise state."""
        with self._rng_lock:
            draw = self._draws
            self._draws += 1
        state = np.random.SeedSequence([self.seed, draw]).generate_state(1, np.uint64)[0]
        return torch.Generator(self.device).manual_seed(int(state) >> 1)

    def _forward(self, images: torch.Tensor, exif: Dict[str, torch.Tensor],
                 guidance=None):
        """One forward of normalized NHWC images on the device."""
        with self._rng_lock:  # handler and dispatcher threads both count
            self.batch_sizes[int(images.shape[0])] += 1
        with torch.no_grad():
            return self.model(images, exif, guidance=guidance,
                              generator=self._next_key(), noise_mode=self.noise_mode)

    def _to_device(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in arrays.items()}

    def _guidance(self, idx) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idx, np.int64), device=self.device)

    def _prep_image(self, image_path: str):
        u8 = load_image_uint8(image_path)
        img = normalize_np(pil_resize_host(u8, self.image_size, self.image_size))
        return img[None].astype(np.float32), u8.shape[:2]

    def predict(
        self, image_path: str, instruction: Optional[str] = None
    ) -> Tuple[float, float, Dict]:
        """Single-image pipeline. Returns (depth, confidence, metadata)."""
        images, original_size = self._prep_image(image_path)
        exif_raw = exif_io.extract_exif(image_path)
        exif = self._to_device(exif_io.exif_arrays_for_model(exif_raw, self.camera_to_id))
        x = torch.from_numpy(images).to(self.device)
        if instruction is not None:
            out = self._forward(x, exif, self._guidance(G.instruction_index(instruction)))
        else:
            out = self._forward(x, exif)

        depth = float(out.depth.squeeze())
        confidence = float(out.confidence.squeeze())
        attention = (
            out.attention[0].cpu().numpy() if out.attention is not None else None
        )
        if self.arch.use_curiosity and out.curiosity is not None:
            self.model.record_exploration(out.curiosity.cpu().numpy())

        if self.save_images:
            from cognitive_aim_tpu_torch.utils.visualize import save_prediction_image

            save_prediction_image(
                images[0], depth, confidence, attention, instruction, image_path,
                self.output_dir,
            )

        metadata = {
            "image_path": image_path,
            "original_size": tuple(int(v) for v in original_size[::-1]),
            "processed_size": (self.image_size, self.image_size),
            "exif_available": exif_raw is not None,
            "exif_source": "real" if exif_raw is not None else "default",
            "instruction": instruction,
            "cognitive_modules": self.config.get(
                "cognitive_modules",
                self.config.get("model", {}).get("cognitive_modules", []),
            ),
            "model_status": {
                "ambient": self.arch.use_ambient,
                "focal": self.arch.use_focal,
                "exif": self.arch.use_exif,
            },
            "exif_data": exif_raw
            or {
                "FocalLength": 50.0,
                "FNumber": 2.8,
                "ISOSpeedRatings": 100,
                "Model": "Default",
                "Make": "Default",
            },
        }
        return depth, confidence, metadata

    def predict_batch(
        self, image_paths: List[str], instructions: Optional[List[Optional[str]]] = None
    ) -> List[Tuple]:
        """One ``predict`` per path; a failure gives (None, None,
        {'error': ...}) in its place."""
        if instructions is None:
            instructions = [None] * len(image_paths)
        elif len(instructions) != len(image_paths):
            raise ValueError("Number of instructions must match number of images")
        results = []
        for path, instr in zip(image_paths, instructions):
            try:
                results.append(self.predict(path, instr))
            except Exception as e:
                results.append((None, None, {"error": str(e)}))
        return results

    def _nine_way(self, images: np.ndarray, exifs: List[Dict[str, np.ndarray]]):
        """All 9 instructions for each image, in ONE forward of batch 9 M
        with a tiled guidance-index vector."""
        n = len(G.INSTRUCTIONS)
        batch = torch.from_numpy(np.repeat(images, n, axis=0)).to(self.device)
        exif = self._to_device({k: np.concatenate([np.repeat(e[k], n, axis=0)
                                                   for e in exifs]) for k in exifs[0]})
        gi = self._guidance(np.tile(np.arange(n), len(exifs)))
        out = self._forward(batch, exif, gi)
        return (out.depth.squeeze(-1).cpu().numpy(), out.confidence.squeeze(-1).cpu().numpy(),
                out.attention.cpu().numpy())

    def predict_all_instructions(self, image_path: str) -> Dict[str, Tuple[float, float]]:
        """All 9 instructions in ONE batched forward. Returns {instruction:
        (depth, confidence)} and writes the 9 prediction PNGs."""
        images, _ = self._prep_image(image_path)
        exif = exif_io.exif_arrays_for_model(exif_io.extract_exif(image_path),
                                             self.camera_to_id)
        depths, confs, attn = self._nine_way(images, [exif])
        results = {}
        for i, name in enumerate(G.INSTRUCTIONS):
            results[name] = (float(depths[i]), float(confs[i]))
            if self.save_images:
                from cognitive_aim_tpu_torch.utils.visualize import save_prediction_image

                save_prediction_image(
                    images[0], float(depths[i]), float(confs[i]), attn[i], name,
                    image_path, self.output_dir,
                )
        return results

    def predict_all_instructions_batch(
        self, image_paths: List[str]
    ) -> List[Dict[str, Tuple[float, float]]]:
        """Nine instructions x M images in ONE forward. Returns one
        {instruction: (depth, confidence)} dict per image and writes the
        per-image prediction PNGs."""
        n = len(G.INSTRUCTIONS)
        imgs, exifs = [], []
        for path in image_paths:
            img, _ = self._prep_image(path)
            imgs.append(img)
            exifs.append(exif_io.exif_arrays_for_model(
                exif_io.extract_exif(path), self.camera_to_id))
        depths, confs, attn = self._nine_way(np.concatenate(imgs), exifs)
        results = []
        for m, path in enumerate(image_paths):
            per = {}
            for i, name in enumerate(G.INSTRUCTIONS):
                j = m * n + i
                per[name] = (float(depths[j]), float(confs[j]))
                if self.save_images:
                    from cognitive_aim_tpu_torch.utils.visualize import save_prediction_image

                    save_prediction_image(
                        imgs[m][0], float(depths[j]), float(confs[j]),
                        attn[j], name, path, self.output_dir,
                    )
            results.append(per)
        return results

    def predict_paths_batched(
        self,
        image_paths: List[str],
        instruction: Optional[str] = None,
        batch_size: int = 16,
        mesh=None,
        use_exif: bool = True,
        instructions: Optional[List[str]] = None,
    ) -> List[Tuple[float, float]]:
        """Production serving path: the native C++ loader (threaded decode
        and resize on the host; PIL where it does not build) -> uint8 batches
        copied from pinned memory without blocking -> /255 + ImageNet
        normalization on the device -> the forward. Returns [(depth,
        confidence)] per path ((nan, nan) for failed decodes); writes no
        PNGs. Each chunk is padded to ``batch_size`` with its last image, so
        every forward has one shape.

        Per-image EXIF comes from the loader's APP1 payloads (same ranges
        and defaults as ``predict``); ``use_exif=False`` uses the
        50mm/f2.8/ISO100 defaults. ``instructions`` gives one instruction
        per path, all in one guided forward a chunk; it excludes the scalar
        ``instruction``.

        ``mesh`` (core/mesh.py): the data-parallel path, in SPMD form. Every
        rank calls with the same paths; each chunk is padded with its last
        image to ``pad_batch_to_devices(batch_size, mesh)`` rows, each rank
        decodes and runs its rows of it (the noise draws are the whole
        chunk's, ``comm.batch_shard``), and the (depth, confidence, decoded)
        rows are all-gathered over the batch axes, so every rank returns the
        list that ``mesh=None`` returns (under sampled noise, where
        ``batch_size`` divides over the batch axes: both then draw one
        chunk's noise)."""
        from cognitive_aim_tpu_torch.io import native_loader as NL

        if instructions is not None:
            if instruction is not None:
                raise ValueError("pass either instruction or instructions, not both")
            if len(instructions) != len(image_paths):
                raise ValueError("instructions must match image_paths length")
            gi_all = np.asarray([G.instruction_index(i) for i in instructions], np.int64)
        else:
            gi_all = None
        gi = None if instruction is None else G.instruction_index(instruction)
        self.last_decoder = NL.decoder()
        pin = self.device.type == "cuda"
        if mesh is not None:
            from cognitive_aim_tpu_torch.core.mesh import (
                batch_axes,
                batch_rows,
                pad_batch_to_devices,
            )
            from cognitive_aim_tpu_torch.parallel import comm

            padded = pad_batch_to_devices(batch_size, mesh)
            lo, hi = batch_rows(mesh, padded)

        def _dispatch(chunk, start):
            """Host decode + asynchronous device dispatch of one chunk (this
            rank's rows of it on a mesh); the outputs are fetched later, so
            the device computes this chunk while the caller decodes the
            next."""
            S = self.image_size
            n = len(chunk)
            take = list(range(n)) if mesh is None else [min(i, n - 1) for i in range(lo, hi)]
            rows = [chunk[i] for i in take]
            if use_exif:
                imgs, ok, payloads = NL.decode_resize_batch_u8_exif(rows, S, S)
            else:
                imgs, ok = NL.decode_resize_batch_u8(rows, S, S)
            m = len(rows)
            pad = batch_size - n if mesh is None and n < batch_size else 0
            if use_exif:
                per_image = [
                    exif_io.exif_arrays_for_model(
                        exif_io.extract_exif_from_app1(pl), self.camera_to_id)
                    for pl in payloads
                ]
                exif = {k: np.concatenate([e[k] for e in per_image]) for k in per_image[0]}
            else:
                exif = {
                    "camera_idx": np.zeros(m, np.int32),
                    "focal_length": np.full(m, 50.0, np.float32),
                    "aperture": np.full(m, 2.8, np.float32),
                    "iso": np.full(m, 100.0, np.float32),
                }
            if pad:
                imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, 0)])
                exif = {k: np.concatenate([v, np.repeat(v[-1:], pad, 0)])
                        for k, v in exif.items()}
            host = torch.from_numpy(imgs)
            if pin:
                host = host.pin_memory()
            xb = normalize_u8(host.to(self.device, non_blocking=True))
            eb = self._to_device(exif)
            shard = contextlib.nullcontext()
            if mesh is not None and mesh.distributed:
                shard = comm.batch_shard(mesh, lo, hi, padded, batch_axes(mesh))
            with shard:
                if gi_all is not None:
                    gvec = gi_all[start + np.asarray(take, np.int64)]
                    if pad:
                        gvec = np.concatenate([gvec, np.repeat(gvec[-1:], pad)])
                    out = self._forward(xb, eb, self._guidance(gvec))
                elif gi is not None:
                    out = self._forward(xb, eb, self._guidance(np.full(m + pad, gi)))
                else:
                    out = self._forward(xb, eb)
            if mesh is not None:  # every rank gets every row: depth, confidence, decoded
                got = torch.stack([out.depth[:, 0], out.confidence[:, 0],
                                   torch.as_tensor(ok, dtype=out.depth.dtype, device=self.device)
                                   ], dim=1)
                got = comm.gather_batch(got, mesh, batch_axes(mesh))
                out = (got[:, 0], got[:, 1])
                ok = got[:, 2].cpu().numpy() > 0
            else:
                out = (out.depth[:, 0], out.confidence[:, 0])
            return out, ok, n

        def _drain(pend):
            out, ok, n = pend
            d = out[0].cpu().numpy()
            c = out[1].cpu().numpy()
            return [
                (float(d[i]), float(c[i])) if ok[i] else (float("nan"), float("nan"))
                for i in range(n)
            ]

        # double-buffered: decode and dispatch chunk i+1 before fetching chunk i
        results: List[Tuple[float, float]] = []
        pending = None
        for start in range(0, len(image_paths), batch_size):
            cur = _dispatch(image_paths[start: start + batch_size], start)
            if pending is not None:
                results.extend(_drain(pending))
            pending = cur
        if pending is not None:
            results.extend(_drain(pending))
        return results

    # ------------------------------------------------------------- misc ----
    def save_results(self, results: List[Tuple], output_path: str):
        """JSON writer with fraction handling."""

        def make_serializable(obj):
            if hasattr(obj, "numerator") and hasattr(obj, "denominator"):
                return float(obj.numerator) / float(obj.denominator)
            if isinstance(obj, dict):
                return {k: make_serializable(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return [make_serializable(v) for v in obj]
            try:
                json.dumps(obj)
                return obj
            except (TypeError, ValueError):
                return str(obj)

        serializable = [
            {
                "depth_value": float(d) if d is not None else None,
                "confidence_score": float(c) if c is not None else None,
                "metadata": make_serializable(m),
            }
            for d, c, m in results
        ]
        with open(output_path, "w", encoding="utf-8") as f:
            json.dump(serializable, f, indent=2, ensure_ascii=False)
        print(f"Results saved to: {output_path}")

    def get_exploration_stats(self):
        return self.model.get_exploration_stats()


# ------------------------------------------------- the flat interchange ---
def flatten_tree(tree) -> Dict[str, np.ndarray]:
    """A nested dict / list tree (or an already flat dict) -> ``/``-joined
    keys mapped to numpy arrays, the keys of the JAX ``flatten_tree``."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        else:
            if hasattr(node, "detach"):
                node = node.detach().cpu().numpy()
            flat["/".join(path)] = np.asarray(node)

    walk(tree, [])
    return flat


def npz_meta(npz) -> Dict[str, str]:
    """Provenance stamp read-back: '__meta__/<k>' string entries written
    next to the tensors (train_filter spec, adapter rank/targets). Empty
    for unstamped checkpoints."""
    meta = {}
    for key in getattr(npz, "files", []):
        if key.startswith("__meta__/"):
            meta[key[len("__meta__/"):]] = str(npz[key])
    return meta


def trainer_params(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The parameters of a trainer checkpoint (``params/<name>`` beside
    ``meta/epoch`` and ``meta/best_val_loss``, the layout both trainers
    write) as the flat interchange; any other flat dict as it is. The JAX
    engine reads the prefixed keys as a subtree it does not have and loads
    nothing from such a file."""
    if not any(k.startswith("params/") for k in flat):
        return flat
    return {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")}


def unflatten_npz(npz) -> Dict[str, np.ndarray]:
    """The flat interchange of an npz (or dict): every entry but the
    '__meta__/*' provenance strings, read into memory."""
    keys = npz.files if hasattr(npz, "files") else npz.keys()
    return {k: np.asarray(npz[k]) for k in keys if not k.startswith("__meta__/")}
