"""Mesh construction and sharded BLS computations over torch.distributed.

The counterpart of the JAX package's ``parallel/mesh.py`` (pjit and
shard_map over a device mesh).  A ``Mesh`` is a process group and the
device of this rank; each ``sharded_*`` returns a callable that every rank
of the group calls with its own shard, and whose replicated results (the
masked sum, the pairing product, the quorum verdict) are the same on every
rank.  Shards are equal in size, as shard_map's are.  The collectives run
on the mesh's device: NCCL for CUDA, gloo for the CPU.
"""

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..ops import bls as OB
from ..ops import curve as CV
from ..ops import pairing as OP


@dataclass(frozen=True)
class Mesh:
    """A process group over the batch axis (None: the default group), and
    this rank's device."""

    group: object
    device: torch.device

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)


def make_mesh(device=None, group=None, *, init_method=None, world_size=None,
              rank=None) -> Mesh:
    """A mesh over ``group``, else over the default process group, which is
    initialised here from ``init_method`` (e.g. ``tcp://localhost:<port>``),
    ``world_size`` and ``rank`` where none exists yet.  ``device`` is this
    rank's device (default: the current CUDA device, which must exist);
    the backend follows it, NCCL for CUDA and gloo for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if group is None and not dist.is_initialized():
        if init_method is None or world_size is None or rank is None:
            raise ValueError("no process group: pass init_method, "
                             "world_size and rank to initialise one")
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=init_method, world_size=world_size, rank=rank)
    return Mesh(group, device)


def _all_gather(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """Every rank's ``local`` stacked in rank order, on every rank."""
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local, group=mesh.group)
    return torch.stack(parts)


def sharded_verify(mesh: Mesh):
    """Batch-data-parallel verify: each rank checks its shard of the batch
    (affine pk (b, 2, 32), h and sig (b, 2, 2, 32)) and gets its (b,)
    verdicts; no collective."""

    def fn(pk_aff, h_aff, sig_aff):
        return OB.verify(pk_aff, h_aff, sig_aff)

    return fn


def sharded_masked_sum(mesh: Mesh):
    """Committee-sharded mask aggregation: each rank tree-sums its chunk of
    (pubkey, bit) pairs (Jacobian (n, 3, 32), (n,)), the (3, 32) partial
    sums are all_gathered, and every rank merges them in rank order with
    ``masked_sum(partials, ones)``, the JAX package's order, so the
    Jacobian limbs are its limbs."""

    def fn(pk_jac_chunk, bitmap_chunk):
        local = CV.masked_sum(pk_jac_chunk, bitmap_chunk, CV.FP_OPS)
        partials = _all_gather(mesh, local)
        ones = torch.ones(partials.shape[0], dtype=torch.int32,
                          device=partials.device)
        return CV.masked_sum(partials, ones, CV.FP_OPS)

    return fn


def sharded_pairing_product(mesh: Mesh):
    """prod_k e(P_k, Q_k) with the pair axis sharded: each rank's Miller
    loops over its pairs (p (k, ..., 2, 32), q (k, ..., 2, 2, 32)) and
    their Fp12 product, one all_gather, then on every rank the product of
    the partials in rank order and the final exponentiation."""

    @torch.inference_mode()
    def fn(p_chunk, q_chunk):
        local = OP.fp12_tree_reduce(OP.miller_loop(p_chunk, q_chunk))
        partials = _all_gather(mesh, local)
        return OP.final_exponentiation(OP.fp12_tree_reduce(partials))

    return fn


def sharded_agg_verify(mesh: Mesh):
    """The sharded FBFT quorum check: the committee's Jacobian keys and
    the bitmap sharded over the ranks, the aggregate key built with one
    all_gather (``sharded_masked_sum``), then the 2-pairing verify of the
    affine aggregate, h_aff and agg_sig_aff ((2, 2, 32) each) on every
    rank.  Returns a 0-dim bool tensor."""
    masked = sharded_masked_sum(mesh)

    @torch.inference_mode()
    def fn(pk_jac, bitmap, h_aff, agg_sig_aff):
        agg = masked(pk_jac, bitmap)
        ax, ay = CV.to_affine(agg, CV.FP_OPS)
        pk_aff = torch.stack([ax, ay])[None]
        return OB.verify(pk_aff, h_aff[None], agg_sig_aff[None])[0]

    return fn
