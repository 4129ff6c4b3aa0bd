"""Modality frontend stubs.  The counterpart of src/repro/models/modality.py.

The audio and vision configs specify the transformer backbone only; the
frontend is a stub, as in the reference: precomputed frame or patch
embeddings (B, ``cfg.frontend_len``, d) occupy the first
``cfg.frontend_len`` positions of the sequence (a conditioning prefix or
image patches).  No encoder and no frontend weights exist.
"""
from __future__ import annotations

from typing import Tuple

import torch


def frontend_input_name(cfg) -> str:
    """The batch key of ``cfg``'s frontend input."""
    return {"audio": "frame_embeds", "vision": "patch_embeds"}[cfg.frontend]


def splice_frontend(x_embed: torch.Tensor,
                    frontend_embeds: torch.Tensor) -> torch.Tensor:
    """Replace the first P positions of the token embedding with the
    frontend embeddings, cast to its dtype.  x_embed: (B, S, d);
    frontend_embeds: (B, P, d).  Out of place, so it stays differentiable
    and aliases neither input."""
    P = frontend_embeds.shape[1]
    return torch.cat([frontend_embeds.to(x_embed.dtype), x_embed[:, P:]],
                     dim=1)


def frontend_shape(cfg, batch: int) -> Tuple[int, int, int]:
    """The shape of the stub frontend input for ``batch`` sequences, (batch,
    ``cfg.frontend_len``, ``cfg.d_model``) (the reference's
    ``frontend_spec``)."""
    return (batch, cfg.frontend_len, cfg.d_model)
