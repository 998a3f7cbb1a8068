#!/usr/bin/env python3
"""Where one forward of the PyTorch + CUDA port spends its time on the card.

    python3 scripts/profile_port_forward.py [--policy int8] [--batch 8] [--top 25]
        [--token-filter 2:0.35@p] [--attn-impl pallas_packed_i8qk]
        [--lora 64 [--lora-targets qkv,attn_out,fc1,fc2] [--fold]] [--fuse-aomlp [both]]

Builds the ViT-B 518x518 model (2 focal iterations, random weights from a
seed, ``attn_impl="pallas_packed"`` unless named) under each named policy,
for each ``--token-filter`` specification (may repeat; "" or "off" is the
unfiltered forward, the default), runs guided forwards on device-resident
images, and prints for each (``--lora R`` gives every backbone block rank-R
adapters with a seeded non-zero ``lora_B`` on ``--lora-targets``; ``--fold``
merges them into the weights first, as a deployment does; ``--fuse-aomlp``
sets ``CAIM_FUSE_AOMLP=1``, under which the chained int8 block runs K12
``int8_attnout_mlp_ln`` in place of K3 and K4; ``--fuse-aomlp both`` profiles
each configuration without the variable and then with it, in this one
process, so that the two share a card and its clocks):

  * the forward's time with a synchronise (host clock) and the host's time
    to enqueue it (no synchronise), averaged over --iters forwards;
  * from a ``torch.profiler`` trace of one forward: device time summed by
    kernel name, the device's busy time, the span from the first kernel's
    start to the last one's end, and the idle share of that span.

Needs an NVIDIA GPU; exits 2 without one. Prints the card's name and power
limit first; every number is that card's.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profile_policy(name: str, batch: int, iters: int, top: int, token_filter: str = "",
                   attn_impl: str = "pallas_packed", lora_rank: int = 0,
                   lora_targets=("attn_out",), fold: bool = False):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cognitive_aim_tpu_torch.core.precision import policy_from_name
    from cognitive_aim_tpu_torch.core.rng import NoiseMode
    from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
    from cognitive_aim_tpu_torch.models.config import ModelArchConfig, parse_token_filter

    lora = dict(use_lora=True, lora_rank=lora_rank, lora_alpha=lora_rank,
                lora_targets=tuple(lora_targets)) if lora_rank else {}
    arch = ModelArchConfig(num_iterations=2, image_size=518, **lora,
                           **parse_token_filter(token_filter))
    model = CognitiveAimModel(arch, policy_from_name(name), attn_impl)
    name = f"{name} {attn_impl} filter {token_filter or 'off'}"
    if os.environ.get("CAIM_FUSE_AOMLP", "0") == "1":
        name += " CAIM_FUSE_AOMLP=1"
    gen = torch.Generator(device="cuda").manual_seed(0)
    model.init(gen)
    if lora_rank:
        name += f" adapters rank {lora_rank} {'folded' if fold else 'live'}"
        for blk in model.backbone.layers:
            for target in lora_targets:
                blk.adapter(target)[1].data.normal_(0.0, 0.02, generator=gen)
        if fold:
            model.merge_lora_params()
    model.prepare_params()
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((batch, 518, 518, 3), generator=g, device="cuda")
    gidx = torch.arange(batch, device="cuda") % 9

    @torch.no_grad()  # inference: no autograd graph
    def fwd():
        return model(x, guidance=gidx, noise_mode=NoiseMode.ZEROS)

    for _ in range(3):
        fwd()
    wall = enqueue = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enqueue += t1 - t0
        wall += time.perf_counter() - t0
    print(f"[{name}] B={batch} guided forward: {wall / iters * 1e3:.2f} ms with a "
          f"synchronise, host enqueue {enqueue / iters * 1e3:.2f} ms")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fwd()
        torch.cuda.synchronize()
    by_name = collections.Counter()
    calls = collections.Counter()
    first, last = float("inf"), 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.end - e.time_range.start
            calls[e.name] += 1
            first, last = min(first, e.time_range.start), max(last, e.time_range.end)
    busy = sum(by_name.values())
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    span = last - first
    print(f"[{name}] profiler, one forward: device busy {busy / 1e3:.2f} ms in a span of "
          f"{span / 1e3:.2f} ms, idle share {1 - busy / span:.1%}, "
          f"{sum(calls.values())} device operations")
    for kname, us in by_name.most_common(top):
        print(f"[{name}]   {us / 1e3:8.3f} ms {calls[kname]:4d} x  {kname[:100]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--policy", action="append",
                    help="default, int8 or f32; may repeat (default: default and int8)")
    ap.add_argument("--token-filter", action="append",
                    help="token-filter specification, e.g. 2:0.35@p; may repeat "
                         "(default: off)")
    ap.add_argument("--attn-impl", default="pallas_packed",
                    help="pallas_packed, pallas_packed_i8qk or pallas")
    ap.add_argument("--lora", type=int, default=0, help="adapter rank (default: no adapters)")
    ap.add_argument("--lora-targets", default="attn_out",
                    help="comma-separated: qkv, attn_out, fc1, fc2")
    ap.add_argument("--fold", action="store_true",
                    help="merge the adapters into the weights before the policy's transform")
    ap.add_argument("--fuse-aomlp", nargs="?", const="on", choices=("on", "both"),
                    help="set CAIM_FUSE_AOMLP=1: K12 in place of K3 and K4 (int8 policy); "
                         "'both': each configuration without it, then with it")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_port_forward: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    fuse_modes = {None: (None,), "on": ("1",), "both": ("0", "1")}[args.fuse_aomlp]
    for name in args.policy or ["default", "int8"]:
        for spec in args.token_filter or [""]:
            for fuse in fuse_modes:
                if fuse is not None:  # the block reads the variable at every call
                    os.environ["CAIM_FUSE_AOMLP"] = fuse
                profile_policy(name, args.batch, args.iters, args.top,
                               "" if spec == "off" else spec, args.attn_impl, args.lora,
                               args.lora_targets.split(","), args.fold)
    return 0


if __name__ == "__main__":
    sys.exit(main())
