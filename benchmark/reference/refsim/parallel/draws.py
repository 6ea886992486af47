"""Random draws of a rank's env rows, shaped for every rank's rows.

One process draws each random tensor of a step for all of its E envs at
once (action noise, scan noise or pool rows, the reset's draws).  A rank
that holds rows [lo, lo + e) of them must draw the whole (E, ...) tensor
from its replicated generator and keep its rows: a draw of (e, ...) would
be other numbers.  Inside ``row_draws(total, lo, group)`` every draw made
through ``draw_rows`` does that; outside it draws what it is asked for, so
code that runs on one process is unchanged.  The reset of the done envs
(``rollout.reset_done``) counts the done envs of every rank
(``count_rows``) and draws under the rows of its own ones among them.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist


class RowDraws(NamedTuple):
    """This process's rows [lo, lo + e) of draws made for ``total`` rows."""

    total: int
    lo: int
    group: object   # the process group that holds the other rows


_ROWS: contextvars.ContextVar = contextvars.ContextVar("row_draws", default=None)


@contextlib.contextmanager
def row_draws(total: int, lo: int, group=None):
    """Draw ``total`` rows and keep the caller's, from ``lo``, inside."""
    token = _ROWS.set(RowDraws(total, lo, group))
    try:
        yield
    finally:
        _ROWS.reset(token)


def current() -> RowDraws | None:
    return _ROWS.get()


def draw_rows(e_n: int, draw: Callable[[int], torch.Tensor]) -> torch.Tensor:
    """``draw(n)`` makes a tensor of n leading rows -> this process's e_n
    rows: those of ``draw(total)`` from ``lo`` inside ``row_draws``,
    ``draw(e_n)`` outside."""
    rows = _ROWS.get()
    if rows is None:
        return draw(e_n)
    if rows.lo + e_n > rows.total:
        raise ValueError(f"rows [{rows.lo}, {rows.lo + e_n}) lie outside the "
                         f"{rows.total} rows of the draw")
    return draw(rows.total)[rows.lo:rows.lo + e_n]


def collective_device(group) -> torch.device:
    """Where a collective's tensors live: the card under NCCL, else the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_counts(n: int, group=None) -> list[int]:
    """Every rank's ``n``, in rank order (one all-gather of an int64)."""
    dev = collective_device(group)
    world = dist.get_world_size(group)
    mine = torch.tensor([n], dtype=torch.int64, device=dev)
    out = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(out, mine, group=group)
    return [int(c) for c in torch.cat(out).cpu()]


def count_rows(n: int, group=None) -> tuple[int, int]:
    """(the sum of every rank's ``n``, the sum over the ranks before this
    one): a rank's rows [before, before + n) of the group's rows."""
    counts = gather_counts(n, group)
    return sum(counts), sum(counts[:dist.get_rank(group)])


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """SUM over the group of ``t`` -> a new tensor on ``t``'s device (through
    the host under gloo when ``t`` is on the card)."""
    dev = collective_device(group)
    buf = t.detach().to(dev).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device)
