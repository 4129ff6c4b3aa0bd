"""Training data of the port.  ``synthetic`` is a copy of
src/repro/data/synthetic.py (numpy only, so batches are bitwise the
reference's); ``pipeline.py`` waits for a path that uses it (ROADMAP
Queue 1)."""
from repro_torch.data.synthetic import DataConfig, SyntheticLM  # noqa: F401
