from repro_torch.checkpoint.ckpt import latest_step, prune, restore, save  # noqa: F401
