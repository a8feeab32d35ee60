"""The port's sharded pipelines across spawned gloo ranks on the CPU, one
process per shard (stereo_matchin_tpu_torch.parallel), against the port's
unsharded pipelines and the JAX package's sharded ones on the virtual
8-device mesh of tests/conftest.py.

Each world size is one module-scoped spawn (parallel.distributed.spawn)
that runs every mesh of that size; each mesh is its own test case over
the spawn's results.  The rank functions live in
stereo_matchin_tpu_torch/parallel/dryrun.py, which imports no JAX.

  * sharded == unsharded: every map bit-equal, on JAX's five ASW meshes
    and three cross meshes (tests/test_parallel.py), including (1, 1, 4)
    with D = 11 padded to 12, and one ASW case at the full geometry;
  * against JAX's make_asw_sharded on the same mesh, disparity codes
    agree on >= 99.5% of pixels (the unsharded pipeline's rate without
    weight injection, tests/test_torch_pipeline_asw.py; `exp` differs);
    cross maps bit-equal to JAX's make_cross_sharded (taps);
  * halo_mode="local" equals the reference on (2, 1, 1) and not on (1, 4, 1);
  * the cross vote's reads past the frame border, on frames where the
    JAX package's sharded pipeline differs from its own unsharded one;
  * exchange_halo bit-equal to JAX's inside shard_map;
  * a two-process rig that initialises from torchrun's environment, and
    the dry run on four ranks.

NCCL is not run here (no card); it runs at world size 1 in chip_smoke.py.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from stereo_matchin_tpu import MeshConfig as JaxMesh
from stereo_matchin_tpu.models import cross_based as jax_cross
from stereo_matchin_tpu.parallel import build_mesh as jax_build_mesh
from stereo_matchin_tpu.parallel import exchange_halo as jax_exchange_halo
from stereo_matchin_tpu.parallel import make_asw_sharded as jax_asw_sharded
from stereo_matchin_tpu.parallel import make_cross_sharded as jax_cross_sharded
from stereo_matchin_tpu_torch import ops as tops
from stereo_matchin_tpu_torch.models import asw, cross_based
from stereo_matchin_tpu_torch.parallel import distributed, dryrun
from stereo_matchin_tpu_torch.parallel.dryrun import (Case, halo_tiles,
                                                      sharded_maps)

from .torch_support import arms_image, config_pair

KW = dict(d_max=10, radius=3, arm_len=4, r_iters=2, k_iters=2)
CROSS_KW = dict(KW, oii_impl="taps")
FULL_KW = dict(d_max=60, radius=16, arm_len=25, r_iters=2, k_iters=1)
BORDER_KW = dict(d_max=10, arm_len=6, oii_impl="taps")
BORDER_SEEDS = (23, 37, 59)
ASW_MESHES = [(1, 4, 1), (2, 1, 1), (1, 1, 4), (2, 2, 2), (1, 2, 4)]
CROSS_MESHES = [(1, 4, 1), (2, 2, 2), (1, 2, 4)]
ASW_MAPS = ("disparity", "filled", "consistency_pre", "consistency_post",
            "wta_left", "wta_right")
CROSS_MAPS = ("initial", "final", "median_left")
TIMEOUT_S = 120.0


def _id(mesh):
    return "b{}r{}d{}".format(*mesh)


def _pair():
    """tests/test_parallel.py's pair: (2, 24, 20, 3), the right view the
    left one rolled 3 columns plus noise."""
    rng = np.random.default_rng(7)
    left = (rng.integers(0, 256, (2, 24, 20, 3)) / np.float32(255.0)).astype(
        np.float32)
    right = np.roll(left, -3, axis=2)
    noise = rng.integers(-10, 11, right.shape) / np.float32(255.0)
    right = np.clip(np.round((right + noise) * 255) / 255.0, 0, 1).astype(
        np.float32)
    return left, right


def _full_pair():
    """tests/test_parallel.py's full-geometry pair: (1, 64, 450, 3)."""
    rng = np.random.default_rng(3)
    left = (rng.integers(0, 256, (1, 64, 450, 3)) / np.float32(255.0)).astype(
        np.float32)
    return left, np.ascontiguousarray(np.roll(left, -5, axis=2))


@pytest.fixture(scope="module")
def one_thread():
    """The unsharded references run their tiny ops on one thread, as the
    ranks do (PyTorch's thread pool costs more than these ops)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _border_pair():
    """Three 24x48 colour-run images (torch_support.arms_image) whose vote
    reads the rows past the frame's top border (see
    test_cross_border_rows_vote_as_the_border_row)."""
    frames = [np.round(arms_image(np.random.default_rng(s), 24, 48, "scene")
                       * 255) / np.float32(255.0) for s in BORDER_SEEDS]
    left = np.stack(frames).astype(np.float32)
    return left, np.ascontiguousarray(np.roll(left, -2, axis=2))


@pytest.fixture(scope="module")
def pairs():
    return {"pair": _pair(), "full": _full_pair(), "border": _border_pair()}


def _key(case):
    return case._replace(cfg=tuple(sorted(case.cfg.items())))


def _spawn(cases, pairs, world):
    out = distributed.spawn(sharded_maps, world, "gloo",
                            (cases, pairs, "cpu"), TIMEOUT_S)
    return {_key(c): r for c, r in zip(cases, out[0])}, out


@pytest.fixture(scope="module")
def ranks(pairs):
    """One spawn per world size (2, 4, 8) running each of its meshes:
    case -> rank 0's record (maps gathered), plus every rank's records."""
    by_world = {}
    for mesh in ASW_MESHES:
        by_world.setdefault(int(np.prod(mesh)), []).append(
            Case("asw", mesh, KW, "pair"))
    for mesh in CROSS_MESHES:
        by_world.setdefault(int(np.prod(mesh)), []).append(
            Case("cross", mesh, CROSS_KW, "pair"))
    for mesh in ((2, 1, 1), (1, 4, 1)):
        by_world[int(np.prod(mesh))].append(
            Case("asw", mesh, KW, "pair", "local"))
    by_world[4].append(Case("asw", (1, 2, 2), FULL_KW, "full"))
    by_world[2].append(Case("cross", (1, 2, 1), BORDER_KW, "border"))
    got, every = {}, {}
    for world, cases in by_world.items():
        g, e = _spawn(cases, {k: pairs[k] for k in {c.pair for c in cases}},
                      world)
        got.update(g)
        every[world] = (cases, e)
    return got, every


@pytest.fixture(scope="module")
def unsharded(pairs, one_thread):
    """The port's unsharded pipelines, frame by frame."""
    out = {}
    for key, kw, method in (("pair", KW, "asw"), ("pair", CROSS_KW, "cross"),
                            ("full", FULL_KW, "asw"),
                            ("border", BORDER_KW, "cross")):
        left, right = (torch.from_numpy(a) for a in pairs[key])
        cfg = config_pair(**kw)[1]
        run = asw.asw_pipeline if method == "asw" else cross_based.cross_pipeline
        frames = [run(l, r, cfg) for l, r in zip(left, right)]
        fields = ASW_MAPS if method == "asw" else CROSS_MAPS
        out[(key, method)] = {f: np.stack([getattr(fr, f).numpy()
                                           for fr in frames]) for f in fields}
    return out


def _assert_maps_equal(got: dict, want: dict, fields):
    for f in fields:
        diff = int((got[f] != want[f]).sum())
        assert got[f].shape == want[f].shape, (f, got[f].shape)
        assert diff == 0, f"{f}: {diff} values differ"


@pytest.mark.parametrize("mesh", ASW_MESHES, ids=_id)
def test_sharded_asw_equals_unsharded(ranks, unsharded, mesh):
    got = ranks[0][_key(Case("asw", mesh, KW, "pair"))]["maps"]
    _assert_maps_equal(got, unsharded[("pair", "asw")], ASW_MAPS)


@pytest.mark.parametrize("mesh", ASW_MESHES, ids=_id)
def test_sharded_asw_codes_agree_with_jax(ranks, pairs, mesh):
    """Against JAX's make_asw_sharded on the same mesh: the weights' `exp`
    differs, so the codes are held to the unsharded pipeline's rate
    (100% measured on this pair)."""
    jcfg = config_pair(**KW)[0]
    left, right = (jnp.asarray(a) for a in pairs["pair"])
    want = jax_asw_sharded(jcfg, jax_build_mesh(JaxMesh(*mesh)))(left, right)
    got = ranks[0][_key(Case("asw", mesh, KW, "pair"))]["maps"]
    for f in ("disparity", "filled", "wta_left", "wta_right"):
        codes = lambda a: tops.unorm8_code(torch.from_numpy(np.array(a)))
        agree = float((codes(got[f]) == codes(getattr(want, f))).float().mean())
        assert agree >= 0.995, (f, agree)


@pytest.mark.parametrize("mesh", CROSS_MESHES, ids=_id)
def test_sharded_cross_equals_unsharded_and_jax(ranks, unsharded, pairs, mesh):
    """Bit-equal to the port's unsharded cross_pipeline (taps) and to JAX's
    make_cross_sharded (taps); an initial pixel that differs from JAX
    would have to be a proven tie (none does on this pair)."""
    got = ranks[0][_key(Case("cross", mesh, CROSS_KW, "pair"))]["maps"]
    _assert_maps_equal(got, unsharded[("pair", "cross")], CROSS_MAPS)
    jcfg = config_pair(**CROSS_KW)[0]
    left, right = (jnp.asarray(a) for a in pairs["pair"])
    want = jax_cross_sharded(jcfg, jax_build_mesh(JaxMesh(*mesh)))(left, right)
    _assert_maps_equal(got, {f: np.asarray(getattr(want, f))
                             for f in CROSS_MAPS}, CROSS_MAPS)


def test_sharded_asw_at_the_full_geometry(ranks, unsharded):
    """radius 16, d_max 60, 64x450 on (1, 2, 2): every map bit-equal."""
    got = ranks[0][_key(Case("asw", (1, 2, 2), FULL_KW, "full"))]["maps"]
    _assert_maps_equal(got, unsharded[("full", "asw")], ASW_MAPS)


def test_cross_border_rows_vote_as_the_border_row(ranks, unsharded, pairs):
    """The vote re-counts the frame's border row (CLAMP_TO_EDGE), so a
    shard's tile rows past the border must carry the border row's colours
    and arms: a median of replicated input rows is not the border row's
    median, and on these frames its arms would change one voted pixel
    each (JAX's make_cross_sharded differs from its cross_pipeline there).
    The port's tiles take the border row (`_clamp_to_frame`): bit-equal to
    the port's and to JAX's unsharded pipelines."""
    got = ranks[0][_key(Case("cross", (1, 2, 1), BORDER_KW, "border"))]["maps"]
    _assert_maps_equal(got, unsharded[("border", "cross")], CROSS_MAPS)
    jcfg = config_pair(**BORDER_KW)[0]
    want = jax.vmap(lambda a, b: jax_cross.cross_pipeline_fused(a, b, jcfg))(
        *(jnp.asarray(a) for a in pairs["border"]))
    _assert_maps_equal(got, {f: np.asarray(getattr(want, f))
                             for f in CROSS_MAPS}, CROSS_MAPS)


@pytest.mark.parametrize("mesh,equal", [((2, 1, 1), True), ((1, 4, 1), False)],
                         ids=["b2r1d1", "b1r4d1"])
def test_local_halo_mode(ranks, unsharded, mesh, equal):
    """halo_mode="local" edge-pads instead of exchanging: exact without row
    seams, and it must differ across seams (the exchange is gone)."""
    got = ranks[0][_key(Case("asw", mesh, KW, "pair", "local"))]["maps"]
    want = unsharded[("pair", "asw")]["disparity"]
    assert np.array_equal(got["disparity"], want) == equal


def test_every_rank_ran_the_plain_route(ranks):
    """On the CPU no kernel launches, every rank of every spawn returned a
    record per case, and rank coordinates cover each mesh once."""
    for world, (cases, every) in ranks[1].items():
        assert len(every) == world
        for k, case in enumerate(cases):
            assert all(r[k]["launches"] == dict.fromkeys(r[k]["launches"], 0)
                       for r in every)
            coords = sorted(r[k]["coord"] for r in every)
            assert coords == sorted(np.ndindex(*case.mesh)), case


@pytest.mark.parametrize("halo,axis", [(2, 0), (6, 0), (3, 1)])
def test_exchange_halo_equals_jax(halo, axis):
    """4 row ranks' strips after exchange_halo against JAX's exchange_halo
    inside shard_map over 4 virtual devices, bit for bit."""
    rng = np.random.default_rng(halo + axis)
    x = rng.random((3, 24, 5) if axis == 1 else (24, 5, 2)).astype(np.float32)
    out = distributed.spawn(halo_tiles, 4, "gloo",
                            (x, (1, 4, 1), halo, axis, "cpu"), TIMEOUT_S)
    mesh = jax_build_mesh(JaxMesh(1, 4, 1))
    spec = P(None, "row") if axis == 1 else P("row")

    def local(v):
        return jax_exchange_halo(v, halo, "row", axis)[0]

    want = np.asarray(jax.shard_map(local, mesh=mesh, in_specs=spec,
                                    out_specs=spec, check_vma=False)(
        jnp.asarray(x)))
    tiles = [tile for _, tile in sorted(out, key=lambda r: r[0])]
    np.testing.assert_array_equal(np.concatenate(tiles, axis=axis), want)


RIG = r"""
import sys
import torch, torch.distributed as dist
from stereo_matchin_tpu_torch.config import StereoConfig
from stereo_matchin_tpu_torch.parallel import (build_pod_mesh, distributed,
                                               make_asw_sharded, scaling_report)
torch.set_num_threads(1)
distributed.initialize("gloo", timeout_s=60)     # torchrun's environment
assert dist.get_world_size() == 2 and dist.get_rank() == int(sys.argv[1])
mesh = build_pod_mesh(row=2, device_type="cpu")   # batch = 2 // 2 = 1
assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {
    "batch": 1, "row": 2, "disp": 1}, mesh.shape
for bad in (lambda: build_pod_mesh(row=3, device_type="cpu"),
            lambda: build_pod_mesh(row=2, batch=2, device_type="cpu")):
    try:
        bad()
        raise SystemExit("a mesh off the world size was accepted")
    except ValueError:
        pass
x = torch.full((3,), float(dist.get_rank()))
out = torch.empty(6)
dist.all_gather_into_tensor(out, x)
assert out.tolist() == [0.0] * 3 + [1.0] * 3, out
cfg = StereoConfig(d_max=5, radius=2, arm_len=3, r_iters=1, k_iters=1)
left = torch.rand(1, 8, 12, 3)
right = torch.roll(left, -1, dims=2)
rep = scaling_report(make_asw_sharded(cfg, mesh), left, right, mesh, runs=1,
                     repeats=1)
assert rep["devices"] == 2 and rep["mpix_s"] > 0 and rep["stable"] is None
dist.destroy_process_group()
print("RIG_OK", dist.is_initialized(), flush=True)
"""


def test_two_process_rig_from_the_torchrun_environment(tmp_path):
    """Two processes initialise from RANK / WORLD_SIZE / MASTER_ADDR /
    MASTER_PORT (as torchrun sets them), build the pod mesh, refuse an
    indivisible one and one of another size, all-gather and run
    scaling_report."""
    port = distributed.free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   PYTHONPATH=os.pathsep.join(sys.path))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RIG, str(rank)], env=env, cwd=tmp_path,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S))
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and "RIG_OK False" in out, err[-2000:]


def test_dryrun_multichip_on_four_cpu_ranks(one_thread):
    """The dry run (the JAX package's dryrun_multichip) on (1, 2, 2)."""
    line = dryrun.dryrun_multichip(4, "gloo", "cpu")
    assert line.startswith("dryrun_multichip ok: mesh(batch=1, row=2, disp=2)")
    assert "with 0 disagreements" in line


def test_spawn_fails_in_bounded_time_when_a_rank_raises():
    """Ranks that raise (a halo past their rows) fail the run with their
    traceback well inside the timeout, and leave no process behind."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="ValueError: a halo of 5 rows"):
        distributed.spawn(halo_tiles, 2, "gloo",
                          (np.zeros((4, 3), np.float32), (1, 2, 1), 5, 0,
                           "cpu"), 60)
    assert time.monotonic() - t0 < 30
    assert not torch.multiprocessing.active_children()
