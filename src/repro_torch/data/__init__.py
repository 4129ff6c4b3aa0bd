"""Training data of the port.  ``synthetic`` is a copy of
src/repro/data/synthetic.py (numpy only, so batches are bitwise the
reference's); ``pipeline`` prefetches its batches, with the stub frontend
input where the model has a frontend, onto the device in a thread."""
from repro_torch.data.synthetic import DataConfig, SyntheticLM  # noqa: F401
