"""Training CLI of the PyTorch + CUDA port (counterpart of train.py).

    python train_torch.py --config configs/experiment_B.yaml --data_dir DIR \\
        [--output_dir DIR] [--resume CKPT] [--epochs N] [--batch_size N] \\
        [--policy default|f32] [--attn pallas_packed|plain|...] [--device cpu]

The same flags as train.py, the same ``training_summary.md`` and the same
auto-resume from
``output_dir/checkpoint.npz`` when the config's ``checkpoint.auto_resume`` is
set. The config resolves with ``lookup="nested"`` by default, as train.py.
The model trains on the CUDA device unless ``--device cpu`` is given; its
attention and focal kernels (K1, K7, K6) run in the forward and their
backward recomputes the plain versions. ``main`` returns the trainer.

Data parallel under torchrun (``WORLD_SIZE`` > 1), one process a card:

    torchrun --nproc_per_node 4 train_torch.py --config ... --data_dir ...

Each process starts ``torch.distributed`` (NCCL; gloo with ``--device cpu``)
and trains on ``make_mesh()``, the (data = world, model = 1) mesh: every rank
loads the same global batches, runs its rows and sums the gradients.
``--tensor-parallel`` puts the blocks' tensor-parallel rules on that mesh's
``model`` axis, as train.py does on its own default mesh. Rank 0 writes the
logs, the summary and the checkpoints.
"""

import argparse
import logging
import os
import random

import numpy as np
import yaml


def main(argv=None):
    parser = argparse.ArgumentParser(description="Cognitive-Aim training (PyTorch + CUDA)")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default="./outputs")
    parser.add_argument("--resume", type=str, help="checkpoint to resume from")
    parser.add_argument("--epochs", type=int, default=None, help="override epochs")
    parser.add_argument("--batch_size", type=int, default=None, help="override batch size")
    parser.add_argument("--tensor-parallel", action="store_true")
    parser.add_argument("--policy", type=str, default="default")
    parser.add_argument("--attn", type=str, default="pallas_packed")
    parser.add_argument("--lookup", type=str, default="nested",
                        choices=["reference", "nested"],
                        help="config lookup semantics; training defaults to 'nested'")
    parser.add_argument("--device", type=str, default=None,
                        help="'cpu' to train on the CPU (default: the CUDA device)")
    args = parser.parse_args(argv)

    with open(args.config, "r", encoding="utf-8") as f:
        config = yaml.safe_load(f)

    seed = 42
    if "reproduction" in config and config["reproduction"].get("deterministic"):
        seed = int(config["reproduction"].get("seed", 42))
    random.seed(seed)
    np.random.seed(seed)

    import torch

    from cognitive_aim_tpu_torch.core.device import resolve_device
    from cognitive_aim_tpu_torch.core.precision import policy_from_name
    from cognitive_aim_tpu_torch.io.dataset import create_dataloaders
    from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
    from cognitive_aim_tpu_torch.models.config import resolve_model_config
    from cognitive_aim_tpu_torch.train.trainer import TrainConfig, Trainer
    from cognitive_aim_tpu_torch.utils.logging import (
        count_parameters,
        get_model_size_mb,
        setup_experiment_directory,
        setup_logging,
    )

    device = resolve_device(args.device)
    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from cognitive_aim_tpu_torch.core.mesh import initialize_distributed, make_mesh

        initialize_distributed(device=device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = make_mesh(device=device)
    lead = mesh is None or mesh.rank == 0
    if lead:
        setup_experiment_directory(args.output_dir, config)
    logger = setup_logging(args.output_dir) if lead else logging.getLogger("train_torch")
    writer = None
    try:
        from torch.utils.tensorboard import SummaryWriter

        if lead:
            writer = SummaryWriter(os.path.join(args.output_dir, "tensorboard"))
    except Exception:
        logger.warning("tensorboard unavailable; scalar logging disabled")

    arch = resolve_model_config(config, lookup=args.lookup)
    model = CognitiveAimModel(arch, policy=policy_from_name(args.policy),
                              attn_impl=args.attn, device=device)
    model.init(torch.Generator(device).manual_seed(seed))

    train_loader, val_loader = create_dataloaders(args.data_dir, config,
                                                  batch_size=args.batch_size, seed=seed)
    if len(train_loader.dataset) == 0:
        raise SystemExit(f"No training data found under {args.data_dir} "
                         "(need train_annotations.json or images/ + depths/)")

    tcfg = TrainConfig.from_raw(config, steps_per_epoch=max(1, len(train_loader)))
    tcfg.tensor_parallel = args.tensor_parallel
    tcfg.seed = seed
    tcfg.freeze_backbone = arch.freeze_backbone
    if args.epochs is not None:
        tcfg.epochs = args.epochs
    if args.batch_size is not None:
        tcfg.batch_size = args.batch_size

    total, _ = count_parameters(model)
    size_mb = get_model_size_mb(model)
    logger.info(f"Model: {total:,} parameters, {size_mb:.1f} MB "
                f"(backbone {'frozen' if arch.freeze_backbone else 'trainable'}, "
                f"lora={'on' if arch.use_lora else 'off'})")
    dev_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    n_ranks = 1 if mesh is None else mesh.size
    with open(os.path.join(args.output_dir, "training_summary.md") if lead else os.devnull,
              "w") as f:
        f.write(
            f"# Training Summary\n\n"
            f"- Backbone: dinov2-{arch.backbone_size} "
            f"({'frozen' if arch.freeze_backbone else 'trainable'}, "
            f"LoRA {'on' if arch.use_lora else 'off'})\n"
            f"- Cognitive modules: ambient={arch.use_ambient} "
            f"focal={arch.use_focal}(iter={arch.num_iterations}) "
            f"exif={arch.use_exif} curiosity={arch.use_curiosity}\n"
            f"- Parameters: {total:,} ({size_mb:.1f} MB)\n"
            f"- Epochs: {tcfg.epochs}, batch {tcfg.batch_size} "
            f"(accum {tcfg.accumulation_steps}), lr {tcfg.learning_rate}, "
            f"wd {tcfg.weight_decay}, scheduler {tcfg.scheduler}\n"
            f"- Image size: {arch.image_size}\n"
            f"- Device: {dev_name}, policy {args.policy}, attention {args.attn}\n"
            f"- Mesh: {n_ranks} rank(s), tp={'on' if tcfg.tensor_parallel else 'off'}\n"
            f"- Seed: {seed}\n"
        )

    trainer = Trainer(model, tcfg, output_dir=args.output_dir, writer=writer, mesh=mesh)
    if args.resume:
        trainer.load_checkpoint(args.resume)
        logger.info(f"Resumed from epoch {trainer.epoch - 1}")
    elif config.get("checkpoint", {}).get("auto_resume"):
        auto = os.path.join(args.output_dir, "checkpoint.npz")
        if os.path.exists(auto):
            trainer.load_checkpoint(auto)
            logger.info(f"Auto-resumed from {auto} (epoch {trainer.epoch - 1})")

    logger.info(f"Starting training for {tcfg.epochs} epochs")
    history = trainer.fit(train_loader, val_loader)
    for h in history[-3:]:
        logger.info(str(h))
    logger.info(f"Training completed. Best validation loss: {trainer.best_val_loss:.6f}")
    if writer:
        writer.close()
    trainer.history = history
    return trainer


if __name__ == "__main__":
    main()
