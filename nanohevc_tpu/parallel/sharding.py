"""Sharded multi-frame encoding over a (frame, space) mesh.

The scaling model (SURVEY §5 "long-context" analog): throughput scales
by sharding the frame batch across devices ('frame' axis, zero
communication) and optionally splitting each plane's rows across the
'space' axis (XLA inserts the halo exchange for the neighbor gathers
as a collective-permute).  Metric reductions (mean PSNR) are the only
other collective.

Everything is expressed as sharding annotations on a single jitted
program — no explicit communication code, per the XLA/jit SPMD model.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nanohevc_tpu.config import EncoderConfig
from nanohevc_tpu.models.all_intra import encode_plane_full
from nanohevc_tpu.ops.metrics import psnr


def _batch_step(planes: jnp.ndarray, qp: jnp.ndarray, *, config: EncoderConfig,
                is_luma: bool = True):
    """(F, H, W) int32 planes -> dict of batched outputs + mean PSNR."""
    n = config.block_size if is_luma else config.chroma_block_size()

    def one(plane):
        return encode_plane_full(
            plane,
            qp,
            n=n,
            mode_set=(config.mode_set if is_luma
                      else config.chroma_modes()),
            decision=config.decision,
            use_dst=config.use_dst(n, is_luma),
            is_intra=config.is_intra,
            bit_depth=config.bit_depth,
            scan=config.scan,
            rdo_cbf=config.rdo_cbf,
            rdoq=config.rdoq,
            dequant_rescale=config.dequant_rescale,
            intra_smoothing=config.intra_smoothing and is_luma,
        )

    out = jax.vmap(one)(planes)
    frame_psnr = jax.vmap(psnr)(planes, out["recon"])
    out["psnr"] = frame_psnr
    out["mean_psnr"] = jnp.mean(frame_psnr)   # cross-device all-reduce under jit
    return out


@lru_cache(maxsize=64)
def _batch_encoder_unsharded(
    config: EncoderConfig, is_luma: bool, donate: bool
) -> Callable:
    step = partial(_batch_step, config=config, is_luma=is_luma)
    return jax.jit(step, donate_argnums=(0,) if donate else ())


def make_batch_encoder(
    config: EncoderConfig,
    mesh: Mesh | None = None,
    is_luma: bool = True,
    donate: bool = False,
) -> Callable:
    """Compile a sharded multi-frame plane encoder.

    Returns fn(planes (F, H, W) int32, qp scalar) -> dict.  With a
    mesh, inputs are annotated P('frame', 'space', None): the frame
    batch spreads over the 'frame' axis and plane rows over 'space'
    (H must divide by the 'space' length; the block grid need not).
    The qp argument is traced, so one compiled program serves every
    QP (what rate control needs).
    """
    if mesh is None:
        # Cached on the (hashable, frozen) config: a fresh jax.jit
        # wrapper per call would retrace AND recompile the same program
        # every encode_sequence/CLI invocation.
        return _batch_encoder_unsharded(config, is_luma, donate)

    in_shardings = (
        NamedSharding(mesh, P("frame", "space", None)),
        NamedSharding(mesh, P()),
    )
    return jax.jit(
        partial(_batch_step, config=config, is_luma=is_luma),
        in_shardings=in_shardings,
        donate_argnums=(0,) if donate else (),
    )


def _closed_loop_step(planes, qp, *, config: EncoderConfig, is_luma: bool):
    """(F, H, W) planes -> closed-loop outputs + per-frame/mean PSNR."""
    from nanohevc_tpu.models.wavefront import encode_planes_closed_loop

    n = config.block_size if is_luma else config.chroma_block_size()
    planes = planes.astype(jnp.int32)
    # Natively batched: the frames interleave their same-index
    # diagonals (see models/wavefront.py).
    out = encode_planes_closed_loop(
        planes,
        qp,
        n=n,
        mode_set=(config.mode_set if is_luma else config.chroma_modes()),
        decision=config.decision,
        use_dst=config.use_dst(n, is_luma),
        bit_depth=config.bit_depth,
        scan=config.scan,
        dequant_rescale=config.dequant_rescale,
        intra_smoothing=config.intra_smoothing and is_luma,
        deblock=config.deblock,
        deblock_chroma=not is_luma,
        sao=config.sao,
        sao_ctb=config.sao_ctb,
        sao_tile=config.sao_tile,
        rdoq=config.rdoq,
    )
    frame_psnr = jax.vmap(psnr)(planes, out["recon"])
    out["psnr"] = frame_psnr
    out["mean_psnr"] = jnp.mean(frame_psnr)
    return out


@lru_cache(maxsize=64)
def _closed_loop_unsharded(
    config: EncoderConfig, is_luma: bool, donate: bool
) -> Callable:
    step = partial(_closed_loop_step, config=config, is_luma=is_luma)
    return jax.jit(step, donate_argnums=(0,) if donate else ())


def make_closed_loop_encoder(
    config: EncoderConfig,
    mesh: Mesh | None = None,
    is_luma: bool = True,
    donate: bool = False,
) -> Callable:
    """Compile a sharded multi-frame CLOSED-LOOP (wavefront) encoder.

    Returns fn(planes (F, H, W) int32, qp scalar) -> dict with batched
    recon/levels/modes plus per-frame and mean PSNR.  Closed-loop
    frames are independent of each other, so the batch shards over the
    'frame' axis with zero communication (the wavefront dependency is
    *within* a frame); rows are replicated — the diagonal recurrence
    cannot split spatially.  Under a mesh the per-shard encode runs in
    `shard_map`, so each device scans its own frames' diagonals with
    no communication inside the loop.  mean_psnr is a `pmean` over
    'frame' (even frame split, so it equals the global mean).  Without
    a mesh the jitted encoder is cached on the frozen config.
    """
    if mesh is None:
        return _closed_loop_unsharded(config, is_luma, donate)

    from jax import shard_map

    def sharded_step(planes, qp):
        out = _closed_loop_step(planes, qp, config=config, is_luma=is_luma)
        out["mean_psnr"] = jax.lax.pmean(out["mean_psnr"], "frame")
        return out

    out_specs = {
        "recon": P("frame", None, None),
        "levels": P("frame", None, None),
        "modes": P("frame", None),
        "psnr": P("frame"),
        "mean_psnr": P(),
    }
    if config.sao:
        # per-frame ((F,) type, (F,) band_pos, (F, 4) offsets)
        out_specs["sao"] = (P("frame"), P("frame"), P("frame", None))
    if config.sao_ctb:
        # (F, nty, ntx) type/band maps + (F, nty, ntx, 4) offsets
        out_specs["sao_ctb"] = (
            P("frame", None, None),
            P("frame", None, None),
            P("frame", None, None, None),
        )
    fn = shard_map(
        sharded_step,
        mesh=mesh,
        in_specs=(P("frame", None, None), P()),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0,) if donate else ())


def encode_batch_sharded(
    planes,
    qp: int,
    config: EncoderConfig,
    mesh: Mesh,
):
    """Convenience wrapper: device_put with sharding, then encode."""
    sharding = NamedSharding(mesh, P("frame", "space", None))
    planes = jax.device_put(jnp.asarray(planes, dtype=jnp.int32), sharding)
    fn = make_batch_encoder(config, mesh)
    return fn(planes, jnp.int32(qp))
