"""The seeded inputs both kinds of cell share, drawn on the device from a
``torch.Generator`` there: prompts as CLIP token ids, click masks, and
numbers drawn uniformly from a range."""

from __future__ import annotations

import torch

BOS, EOS = 49406, 49407  # CLIP's start and end tokens
CONTEXT = 77             # CLIP's context length


def uniform(g, n: int, lo_hi, device) -> torch.Tensor:
    lo, hi = lo_hi
    return lo + (hi - lo) * torch.rand((n,), generator=g, device=device)


def prompt_ids(g, n: int, lengths, device) -> torch.Tensor:
    """``n`` prompts of a drawn number of words (``lengths``: the least
    and the most) between BOS and EOS, padded with EOS."""
    lo, hi = lengths
    count = torch.randint(lo, hi + 1, (n,), generator=g, device=device)
    words = torch.randint(1, BOS - 1, (n, CONTEXT), generator=g,
                          device=device)
    pos = torch.arange(CONTEXT, device=device)[None]
    ids = torch.where(pos <= count[:, None], words,
                      torch.full_like(words, EOS))
    ids[:, 0] = BOS
    return ids


def empty_prompt(n: int, device) -> torch.Tensor:
    """The empty negative prompt: BOS, then EOS to the end."""
    ids = torch.full((n, CONTEXT), EOS, device=device)
    ids[:, 0] = BOS
    return ids


def click_masks(g, n: int, h: int, w: int, area, device) -> torch.Tensor:
    """``n`` masks ``[n, h, w, 1]`` in {0, 1}: an ellipse covering a drawn
    share ``area`` (the least and the most) of the frame, of a drawn
    aspect in [0.6, 1.6], wholly inside it where it fits."""
    u = torch.rand((n, 4), generator=g, device=device)
    a_lo, a_hi = area
    cover = (a_lo + (a_hi - a_lo) * u[:, 0]) * h * w
    aspect = 0.6 + u[:, 1]
    ry = (cover * aspect / torch.pi).sqrt()
    rx = (cover / (aspect * torch.pi)).sqrt()
    cy = ry + u[:, 2] * (h - 2 * ry).clamp(min=0)
    cx = rx + u[:, 3] * (w - 2 * rx).clamp(min=0)
    yy = torch.arange(h, device=device)[None, :, None]
    xx = torch.arange(w, device=device)[None, None, :]
    inside = (((yy - cy[:, None, None]) / ry[:, None, None]) ** 2
              + ((xx - cx[:, None, None]) / rx[:, None, None]) ** 2) <= 1.0
    return inside.float()[..., None]
