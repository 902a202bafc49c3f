"""Lock-less steal-request messaging protocol (paper §IV-B, Alg. 1 & 2).

Each worker owns two cells:

  * ``round``   — monotonically increasing, incremented by the *victim* each
                  time it handles a request (starts at 1);
  * ``request`` — written by *thieves*: the paper packs ``(thief_id << 40) |
                  victim_round`` into one 64-bit cell.

Simulator representation: the request cell is stored as the pair
``(req_round, req_tid)``.  Both halves are always written in the same
vectorized phase, so the pair is atomic *by construction*.

Races are preserved: several thieves targeting one victim in the same step
overwrite each other's request.  The JAX package's scatter lets the highest
lane win; an indexed write on CUDA orders duplicate writes arbitrarily, so
:func:`thief_send` picks the highest lane explicitly and gives the same
answer on every device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

I32 = torch.int32

ROUND_BITS = 40  # paper layout: 40-bit round | 24-bit worker id


def pack(thief_id: int, round_: int) -> int:
    """Reference 64-bit packing (host-side, used by tests)."""
    return ((int(thief_id) << ROUND_BITS)
            | (int(round_) & ((1 << ROUND_BITS) - 1)))


def unpack(req: int) -> Tuple[int, int]:
    return int(req) >> ROUND_BITS, int(req) & ((1 << ROUND_BITS) - 1)


class Cells(NamedTuple):
    round: torch.Tensor      # (W,) int32, victim-owned
    req_round: torch.Tensor  # (W,) int32, thief-written (pairs with req_tid)
    req_tid: torch.Tensor    # (W,) int32


def make(n_workers: int, device="cpu") -> Cells:
    return Cells(
        round=torch.ones(n_workers, dtype=I32, device=device),
        # 0 < round=1 -> slot free
        req_round=torch.zeros(n_workers, dtype=I32, device=device),
        req_tid=torch.full((n_workers,), -1, dtype=I32, device=device),
    )


def last_writer(idx: torch.Tensor, write: torch.Tensor, size: int
                ) -> torch.Tensor:
    """For each of ``size`` targets, the highest lane ``i`` with
    ``write[i]`` and ``idx[i] == target`` (-1 where none): the winner of a
    racy scatter, chosen explicitly.  Lanes whose index falls outside
    ``[0, size)`` are dropped, like the JAX package's ``mode="drop"``."""
    W = idx.shape[0]
    lane = torch.arange(W, dtype=I32, device=idx.device)
    live = write & (idx >= 0) & (idx < size)
    win = torch.full((size + 1,), -1, dtype=I32, device=idx.device)
    return win.scatter_reduce(0, torch.where(live, idx, size).long(), lane,
                              "amax")[:size]


def thief_send(cells: Cells, thief: torch.Tensor, victim: torch.Tensor,
               mask: torch.Tensor) -> Tuple[Cells, torch.Tensor]:
    """Alg. 1: thief reads the victim's round and request cells; if the
    pending request is stale (``curr < round``) it writes a fresh request
    carrying the victim's current round and its own id.  Returns
    (cells', sent).  Reads clamp out-of-range victims and writes drop them,
    as in the JAX package."""
    W = cells.round.shape[0]
    vs = victim.clamp(0, W - 1).long()
    v_round = cells.round[vs]
    curr = cells.req_round[vs]
    sent = mask & (curr < v_round)
    win = last_writer(victim, sent, W)
    has = win >= 0
    wl = win.clamp(min=0).long()
    req_round = torch.where(has, v_round[wl], cells.req_round)
    req_tid = torch.where(has, thief[wl], cells.req_tid)
    return Cells(cells.round, req_round, req_tid), sent


def victim_valid(cells: Cells) -> torch.Tensor:
    """Alg. 2 line 3: a request is valid iff its round equals the victim's
    current round (stale requests are ignored)."""
    return cells.req_round == cells.round


def victim_advance(cells: Cells, handled: torch.Tensor) -> Cells:
    """Alg. 2 line 5: handling a request re-opens the slot."""
    return cells._replace(round=cells.round + handled.to(I32))
