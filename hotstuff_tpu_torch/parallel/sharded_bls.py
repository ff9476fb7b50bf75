"""The BLS multi-digest check sharded over a mesh: the port of
hotstuff_tpu/parallel/sharded_bls.py.

A timeout certificate's check is a product of n + 1 pairings under one
final exponentiation.  Miller loops are independent across pairing rows,
so the rows shard across the mesh: each shard runs miller_accumulate on
its rows and folds them into one Fq12 value on its own device
(fq12_product, the reference's ``_fold_product``), one (12, 48) element
per shard is copied to the lead, and the lead runs final_exp on the
(1, n_dev, 12, 48) partials and reads the verdict.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bls381 as D
from ..ops.kern import fq12_tower as T
from .mesh import Mesh


def _shard_partial(lines: torch.Tensor, present: torch.Tensor
                   ) -> torch.Tensor:
    """(rows, S, 2, 12, 48) Miller lines and (rows,) present flags on one
    shard -> the product of its present rows' Miller values, (12, 48):
    absent rows (padding) contribute one."""
    fs = D.miller_accumulate(lines)
    one = D.fq12_one((fs.shape[0],), fs.device)
    fs = torch.where((present > 0)[:, None, None], fs, one)
    return T.fq12_product(fs.contiguous())


def check_rows_sharded(mesh: Mesh, rows: list) -> bool:
    """The pairing product of ``rows`` (each (S, 2, 12, 48) Miller lines)
    is one, with the rows split over the mesh: padded to a multiple of
    the mesh size by copies of the first row, masked out."""
    n = len(rows)
    n_dev = mesh.size
    m = -(-n // n_dev) * n_dev
    per = m // n_dev
    present = np.zeros((m,), np.int32)
    present[:n] = 1
    lines = np.stack(rows + [rows[0]] * (m - n))
    partials = []
    for i, dev in enumerate(mesh.devices):
        with mesh.on(i):
            sl = slice(i * per, (i + 1) * per)
            partials.append(_shard_partial(
                torch.from_numpy(lines[sl]).to(dev),
                torch.from_numpy(present[sl]).to(dev)))
    with mesh.on("lead"):
        allp = torch.stack([p.to(mesh.lead) for p in partials])
        ok, _ = T.final_exp(allp.unsqueeze(0))
        return bool(ok[0].cpu())


def verify_aggregate_multi_sharded(mesh: Mesh, pks, msgs, agg_sig) -> bool:
    """Distinct-message aggregate verify sharded over ``mesh``: the
    statement of ops/bls381.verify_aggregate_multi, prod e(pk_i, H(m_i))
    * e(-g1, agg) == 1, validated and turned into rows by the shared
    multi_pairing_rows, so the two verifiers accept the same inputs."""
    rows = D.multi_pairing_rows(pks, msgs, agg_sig)
    if rows is None:
        return False
    return check_rows_sharded(mesh, rows)
