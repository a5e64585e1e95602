"""SAM2 fine-tuning: losses, the train step, LoRA adapters, checkpoints
and the folder dataset (the JAX package's `train/` without the YOLO and
reader trainers)."""
