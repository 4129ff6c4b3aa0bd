from repro_torch.apps import graphcolor  # noqa: F401
