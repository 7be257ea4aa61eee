"""The port's compiled entry points against the JAX package's jitted ones.

`gme_tpu_torch.utils.compiled` captures CUDA graphs on the card; on the
CPU a compiled function runs its body, so here each compiled entry is held
to its jitted JAX counterpart on the same numpy inputs (integers exactly,
parameters to PARAM_ATOL, exact on FMA hosts, PSNR to 1e-4 dB):

- the step: `gme_pipeline_batch` (default, `-sp 0/1/2`),
  `gme_pipeline_step_jit`, `global_motion_estimation_jit`, the adaptive
  batch and its compiled `_merge_adaptive`;
- `get_motion_field_jit` under each procedure, 2D-log's chunked loop
  stopped by `max_iters` inside a chunk and after several chunks, the
  gather diamond's too;
- `get_pyramids_jit`, `get_motion_field_affine_jit`, `compensate_frame_jit`,
  `psnr_jit` and direct GME's `optimize_level`.

And what makes a capture possible, checked on the CPU: the fit runs on
`meta` tensors (no host copy), the default step and the spatial band
program read nothing back to the host and make no tensor from host data
but 0-dim scalars, 2D-log reads once a chunk, `while_loop` keeps the
loop's semantics, and the helper's cache key; the compiled spatial step
equals its eager body; the band program's `psum` and error gather deliver
to every device, its step sends nothing back out, and a collective step
groups its copies by (source, target) device.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gme_tpu.config import GMEConfig as JaxGMEConfig
from gme_tpu.models import direct as jdirect
from gme_tpu.models import gme as jgme
from gme_tpu.ops import affine as jaff
from gme_tpu.ops import bbme as jbbme
from gme_tpu.ops import metrics as jmetrics
from gme_tpu.ops import pyramid as jpyr
from gme_tpu.ops import warp as jwarp
import gme_tpu_torch
from gme_tpu_torch.config import DIAMOND, EXHAUSTIVE, MAE, MSE, THREESTEP, TWODLOG, GMEConfig
from gme_tpu_torch.models import direct as tdirect
from gme_tpu_torch.models import gme as tgme
from gme_tpu_torch.ops import affine as taff
from gme_tpu_torch.ops import bbme as tbbme
from gme_tpu_torch.ops import cuda_kernels
from gme_tpu_torch.parallel import spatial
from gme_tpu_torch.parallel.mesh import make_mesh
from gme_tpu_torch.utils import compiled as C
from test_direct import _smooth_image
from test_torch_ops import PARAM_ATOL, PSNR_ATOL
from test_torch_pipeline import INT_KEYS, _smooth_frame


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pairs(seed=0, H=64, W=64, shifts=((2, 3), (16, 16))):
    rng = np.random.RandomState(seed)
    prev = _smooth_frame(rng, H, W)
    return (np.stack([prev] * len(shifts)),
            np.stack([np.roll(prev, s, (0, 1)) for s in shifts]))


def _same_step(got, want):
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    assert set(got) == set(want)
    for k in INT_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["parameters"], want["parameters"], rtol=0, atol=PARAM_ATOL)
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=0, atol=PSNR_ATOL)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("options", [{}, {"searching_procedure": 0},
                                     {"searching_procedure": 1}, {"searching_procedure": 2}])
def test_compiled_batch_matches_jitted_jax(options):
    prev, curr = _pairs()
    jcfg = JaxGMEConfig(search_impl="volume", **options)
    cfg = GMEConfig.from_dict(dataclasses.asdict(jcfg))
    assert isinstance(gme_tpu_torch.gme_pipeline_batch, C.Compiled)
    want = jgme.gme_pipeline_batch(jnp.asarray(prev), jnp.asarray(curr), jcfg)
    _same_step(gme_tpu_torch.gme_pipeline_batch(_t(prev), _t(curr), cfg), want)


def test_step_and_gme_jit_match_jitted_jax():
    prev, curr = _pairs(1)
    jcfg = JaxGMEConfig(search_impl="volume")
    cfg = GMEConfig.from_dict(dataclasses.asdict(jcfg))
    for i in range(len(prev)):
        want = jgme.gme_pipeline_step_jit(jnp.asarray(prev[i]), jnp.asarray(curr[i]), jcfg)
        _same_step(tgme.gme_pipeline_step_jit(_t(prev[i]), _t(curr[i]), cfg), want)
    want = np.stack([np.asarray(jgme.global_motion_estimation_jit(
        jnp.asarray(p), jnp.asarray(c), jcfg)) for p, c in zip(prev, curr)])
    got = tgme.global_motion_estimation_jit(_t(prev), _t(curr), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PARAM_ATOL)


def test_adaptive_batch_and_merge_match_jax():
    """A (2, 2) pair and a (16, 16) pair under the fast radii: the second
    escapes, so the full tier runs and the compiled merge picks per pair."""
    prev, curr = _pairs(0, shifts=((2, 2), (16, 16)))
    jcfg = JaxGMEConfig(search_impl="volume")
    cfg = GMEConfig.from_dict(dataclasses.asdict(jcfg))
    fast = tgme.gme_pipeline_batch(_t(prev), _t(curr), cfg.fast())
    assert fast["volume_edge_hits"][0] == 0 and fast["volume_edge_hits"][1] > 0
    want = jgme.gme_pipeline_batch_adaptive(jnp.asarray(prev), jnp.asarray(curr), jcfg)
    _same_step(tgme.gme_pipeline_batch_adaptive(_t(prev), _t(curr), cfg), want)
    full = tgme.gme_pipeline_batch(_t(prev), _t(curr), cfg)
    escaped = torch.tensor([False, True])
    jfast = {k: jnp.asarray(v.numpy()) for k, v in fast.items()}
    jfull = {k: jnp.asarray(v.numpy()) for k, v in full.items()}
    want = jgme._merge_adaptive(jfast, jfull, jnp.asarray(escaped.numpy()))
    got = tgme._merge_adaptive(fast, full, escaped)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


# ---------------------------------------------------------------------------
# get_motion_field_jit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sp,max_iters", [
    (EXHAUSTIVE, 4096), (THREESTEP, 4096), (TWODLOG, 4096), (TWODLOG, 3),
    (TWODLOG, tbbme.LOOP_CHUNK + 2), (DIAMOND, 4096),
])
def test_get_motion_field_jit_matches_jitted_jax(sp, max_iters):
    """`cli bbme`'s defaults (MAE, bs 12, sw 8) on a 96x120 pair moved
    (5, -7): 2D-log cut at 3 steps stops inside its first chunk, at
    LOOP_CHUNK + 2 inside its second."""
    rng = np.random.RandomState(7)
    prev = _smooth_frame(rng, 96, 120)
    curr = np.roll(prev, (5, -7), (0, 1))
    kw = dict(block_size=12, search_window=8, searching_procedure=sp, pnorm_distance=MAE,
              max_iters=max_iters, search_impl="volume")
    want = np.asarray(jbbme.get_motion_field_jit(jnp.asarray(prev), jnp.asarray(curr), **kw))
    got = tbbme.get_motion_field_jit(_t(prev)[None], _t(curr)[None], **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("max_iters", [1, tbbme.LOOP_CHUNK, 4096])
def test_gather_diamond_chunked_loop_matches_jax(max_iters):
    rng = np.random.RandomState(8)
    prev = _smooth_frame(rng, 64, 80)
    curr = np.roll(prev, (9, 11), (0, 1))
    kw = dict(block_size=8, searching_procedure=DIAMOND, pnorm_distance=MSE,
              max_iters=max_iters, search_impl="gather")
    want = np.asarray(jbbme.get_motion_field_jit(jnp.asarray(prev), jnp.asarray(curr), **kw))
    got = tbbme.get_motion_field_jit(_t(prev)[None], _t(curr)[None], **kw)
    np.testing.assert_array_equal(got[0].numpy(), want)


def _loop_inputs(search, moved):
    """A pair and the search arguments of the 2D-log test above
    (`test_get_motion_field_jit_matches_jitted_jax`) or of the gather
    diamond's; a still pair when not `moved`."""
    if search == "2D-log":
        rng = np.random.RandomState(7)
        prev = _smooth_frame(rng, 96, 120)
        shift = (5, -7)
        kw = dict(block_size=12, search_window=8, searching_procedure=TWODLOG,
                  pnorm_distance=MAE, search_impl="volume")
    else:
        rng = np.random.RandomState(8)
        prev = _smooth_frame(rng, 64, 80)
        shift = (9, 11)
        kw = dict(block_size=8, searching_procedure=DIAMOND, pnorm_distance=MSE,
                  search_impl="gather")
    return prev, np.roll(prev, shift, (0, 1)) if moved else prev.copy(), kw


@pytest.mark.parametrize("search,moved,max_iters", [
    ("2D-log", True, 1), ("2D-log", True, tbbme.LOOP_CHUNK), ("2D-log", True, 4096),
    ("2D-log", False, 4096), ("gather diamond", True, 1),
    ("gather diamond", True, tbbme.LOOP_CHUNK), ("gather diamond", True, 4096),
    ("gather diamond", False, 4096),
])
def test_while_node_body_looped_on_the_host(monkeypatch, search, moved, max_iters):
    """The function a WHILE node captures (`_loop_chunk`: the chunk in
    place, the counter, the next flag), looped on the host as the node
    loops it (the first flag set before the node, then the body while its
    flag is true), gives eager `while_loop`'s field and jitted JAX's
    `lax.while_loop`'s, and its counter the eager loop's chunks; at
    max_iters 1, and on a still 2D-log pair, the first flag is false."""
    prev, curr, kw = _loop_inputs(search, moved)
    kw["max_iters"] = max_iters
    want = np.asarray(jbbme.get_motion_field_jit(jnp.asarray(prev), jnp.asarray(curr), **kw))
    chunks = []
    loop_chunk = C._loop_chunk

    def counted_chunk(*args):
        chunks[-1] += 1
        return loop_chunk(*args)

    def eager_loop(cond, body, state, chunk):
        chunks.append(0)
        return C.while_loop(cond, body, state, chunk)

    monkeypatch.setattr(C, "_loop_chunk", counted_chunk)
    monkeypatch.setattr(tbbme, "while_loop", eager_loop)
    eager = tbbme.get_motion_field(_t(prev)[None], _t(curr)[None], **kw)
    monkeypatch.undo()
    firsts, runs = [], []

    def while_node(cond, body, state, chunk):
        state = tuple(t.clone() for t in state)
        counter = torch.zeros(2, dtype=torch.int64)
        flag = cond(state)  # set before the node
        firsts.append(bool(flag))
        while bool(flag):  # the node's test of its condition
            flag = C._loop_chunk(cond, body, state, chunk, counter)
        runs.append(counter.tolist())
        return state

    monkeypatch.setattr(tbbme, "while_loop", while_node)
    got = tbbme.get_motion_field(_t(prev)[None], _t(curr)[None], **kw)
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert torch.equal(got, eager)
    assert runs == [[n, n] for n in chunks] and len(runs) == 1, (runs, chunks)
    assert firsts == [runs[0][0] > 0]
    if max_iters == 1 or (search == "2D-log" and not moved):
        assert runs == [[0, 0]]
    if max_iters == 4096 and moved:
        assert runs[0][0] > 1  # the pan needs more than one chunk


# ---------------------------------------------------------------------------
# The small compiled ops and direct GME
# ---------------------------------------------------------------------------

def test_small_jit_ops_match_jitted_jax():
    rng = np.random.RandomState(9)
    img = rng.randint(0, 256, (2, 37, 52)).astype(np.uint8)
    want = jpyr.get_pyramids_jit(jnp.asarray(img[0]), levels=3)
    got = gme_tpu_torch.get_pyramids_jit(_t(img), levels=3)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))

    params = (rng.randn(2, 6) * np.array([3, 0.02, 0.02, 3, 0.02, 0.02])).astype(np.float32)
    got_f = gme_tpu_torch.get_motion_field_affine_jit((4, 5), _t(params))
    for i in range(2):
        want_f = np.asarray(jaff.get_motion_field_affine_jit((4, 5), jnp.asarray(params[i])))
        np.testing.assert_array_equal(got_f[i].numpy(), want_f)

    frame = rng.randint(0, 256, (2, 64, 80)).astype(np.uint8)
    field = rng.randint(-6, 7, (2, 4, 5, 2)).astype(np.int16)
    got_c = gme_tpu_torch.compensate_frame_jit(_t(frame), _t(field))
    other = rng.randint(0, 256, (2, 64, 80)).astype(np.uint8)
    got_p = gme_tpu_torch.psnr_jit(_t(frame), _t(other))
    for i in range(2):
        want_c = np.asarray(jwarp.compensate_frame_jit(jnp.asarray(frame[i]),
                                                       jnp.asarray(field[i])))
        np.testing.assert_array_equal(got_c[i].numpy(), want_c)
        want_p = float(jmetrics.psnr_jit(jnp.asarray(frame[i]), jnp.asarray(other[i])))
        assert abs(float(got_p[i]) - want_p) <= PSNR_ATOL


@pytest.mark.parametrize("model,n", [("perspective", 8), ("affine", 6)])
def test_optimize_level_matches_jitted_jax(model, n):
    """The compiled Adam loop of one level: 12 steps from a known motion."""
    prev = _smooth_image(48, 64)
    true = np.array(jdirect.identity_params(model)) + np.float32(0.01)
    if model == "perspective":
        true[6:] = 0
    curr = np.asarray(jdirect.warp_backward(jnp.asarray(prev), jnp.asarray(true), model))
    p0 = np.array(jdirect.identity_params(model))
    want_p, want_l = jdirect.optimize_level(jnp.asarray(p0), jnp.asarray(prev),
                                            jnp.asarray(curr), model=model, iterations=12)
    got_p, got_l = tdirect.optimize_level(_t(p0), _t(prev), _t(curr), model=model,
                                          iterations=12)
    assert got_l.shape == (12,) and got_p.shape == (n,)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=1e-4)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# What a capture needs, on the CPU
# ---------------------------------------------------------------------------

def test_params_from_moments_runs_on_meta_tensors():
    """The fit makes no host copy: it runs on `meta` tensors, which have no
    data to copy, and keeps their device."""
    mom = torch.empty((5, 12), dtype=torch.int64, device="meta")
    out = taff.params_from_moments(mom)
    assert out.device.type == "meta" and out.shape == (5, 6) and out.dtype == torch.float32


class _HostTraffic(TorchDispatchMode):
    """Counts reads of a tensor's value on the host (`item`, `bool`, ...)
    and tensors made from host data that are not 0-dim scalars (a copy to
    the card on CUDA); paused inside the kernel wrappers, whose plain
    versions stand in for kernels here."""

    def __init__(self):
        super().__init__()
        self.reads = 0
        self.uploads = []
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.paused:
            if func is torch.ops.aten._local_scalar_dense.default:
                self.reads += 1
            elif func is torch.ops.aten.lift_fresh.default and out.dim() > 0:
                self.uploads.append(tuple(out.shape))
        return out


def _watch(monkeypatch, mode):
    for name in cuda_kernels.LAUNCHES:
        wrapper = getattr(cuda_kernels, name)

        def paused(*args, _wrapper=wrapper, **kw):
            mode.paused += 1
            try:
                return _wrapper(*args, **kw)
            finally:
                mode.paused -= 1

        monkeypatch.setattr(cuda_kernels, name, paused)


@pytest.mark.parametrize("options,reads", [({}, 0), ({"searching_procedure": 2}, None)])
def test_step_reads_nothing_back(monkeypatch, options, reads):
    """The default step reads no tensor on the host and makes no tensor
    from host data but 0-dim scalars (read as kernel arguments on the card);
    `-sp 2` reads once per chunk of each of its three 2D-log loops."""
    prev, curr = (_t(a) for a in _pairs(3))
    cfg = GMEConfig(search_impl="volume", **options)
    mode = _HostTraffic()
    _watch(monkeypatch, mode)
    with mode:
        tgme.gme_pipeline_batch_eager(prev, curr, cfg)
    assert mode.uploads == []
    if reads is not None:
        assert mode.reads == reads
    else:
        assert 3 <= mode.reads <= 3 * (1 + cfg.max_search_iters // tbbme.LOOP_CHUNK)


def test_while_loop_is_the_masked_loop():
    """Chunks of masked steps give the unchunked loop's state: a count to
    a per-element limit, capped at `max_iters` inside a chunk."""
    limit = torch.tensor([0, 1, 5, 13, 30])
    for max_iters in (0, 4, 9, 100):
        def body(s):
            x, it = s
            go = (x < limit) & (it < max_iters)
            return torch.where(go, x + 1, x), it + 1

        def cond(s):
            return (s[0] < limit).any() & (s[1] < max_iters)

        x, it = C.while_loop(cond, body, (torch.zeros(5, dtype=torch.int64),
                                          torch.zeros((), dtype=torch.int64)), chunk=4)
        assert torch.equal(x, limit.clamp(max=max_iters)), max_iters
        assert int(it) % 4 == 0


def test_while_loop_in_a_split_capture_runs_eagerly():
    """A split session (the band program's) makes no WHILE node: its
    `while_loop` runs eagerly, reading the condition on the host once per
    chunk and once at the end, which a capture on the card refuses; on the
    CPU the plan is one segment with no loop."""
    limit = torch.tensor([0, 1, 5, 13, 30])

    def body(s):
        x, it = s
        return torch.where(x < limit, x + 1, x), it + 1

    def fn(x):
        return C.while_loop(lambda s: (s[0] < limit).any(), body,
                            (x, torch.zeros((), dtype=torch.int64)), 4)

    x = torch.zeros(5, dtype=torch.int64)
    split = C.compiled(fn, split=True)
    mode = _HostTraffic()
    with mode:
        got = split(x)
    assert torch.equal(got[0], limit) and int(got[1]) == 32
    assert mode.reads == 32 // 4 + 1
    assert len(split.last_entry.graphs) == 1 and not split.last_entry.steps
    assert split.last_entry.loops == []


def test_compiled_key_and_cpu_calls():
    """One entry per (static arguments, shapes, dtypes, devices, other
    values): the same cfg and shapes reuse a key, a new batch size or cfg
    makes another.  On the CPU the body runs and no entry is made."""
    step = tgme.gme_pipeline_batch
    a = torch.zeros((2, 64, 64), dtype=torch.uint8)
    b = torch.zeros((3, 64, 64), dtype=torch.uint8)
    cfg = GMEConfig()
    assert step.key(a, a, cfg) == step.key(a.clone(), a.clone(), cfg=cfg)
    assert step.key(a, a) == step.key(a, a, GMEConfig())
    assert step.key(a, a, cfg) != step.key(b, b, cfg)
    assert step.key(a, a, cfg) != step.key(a, a, cfg.replace(searching_procedure=1))
    assert step.key(a, a, cfg) != step.key(a, a.to(torch.int16), cfg)
    merge = tgme._merge_adaptive
    out = {"x": torch.zeros(2, 3)}
    assert merge.key(out, out, torch.ones(2, dtype=torch.bool)) != merge.key(
        {"y": torch.zeros(2, 3)}, {"y": torch.zeros(2, 3)}, torch.ones(2, dtype=torch.bool))
    n = len(step.entries)
    tgme.gme_pipeline_batch(a, a, cfg)
    assert len(step.entries) == n == 0
    with pytest.raises(ValueError, match="no arguments named"):
        C.compiled(lambda x: x, static_argnames=("y",))


# ---------------------------------------------------------------------------
# The spatial band program (parallel/spatial.py)
# ---------------------------------------------------------------------------

def _spatial_pairs(seed=4, B=2, H=64, W=96):
    rng = np.random.RandomState(seed)
    prev = np.stack([_smooth_frame(rng, H, W) for _ in range(B)])
    curr = np.stack([np.roll(p, (1 + k, 2 - k), (0, 1)) for k, p in enumerate(prev)])
    return _t(prev), _t(curr)


@pytest.mark.parametrize("space,procedure", [(2, DIAMOND), (4, DIAMOND), (4, THREESTEP),
                                             (4, EXHAUSTIVE)])
def test_spatial_program_reads_nothing_back(monkeypatch, space, procedure):
    """The lockstep band program, every slot one device, reads no tensor on
    the host and makes no tensor from host data but 0-dim scalars: the band
    origins are filled on the device, so the program captures whole.  So
    does the segmented program, its split session counting its steps."""
    prev, curr = _spatial_pairs()
    cfg = GMEConfig(searching_procedure=procedure)
    mesh = make_mesh(1, space, ["cpu"] * space)
    for program in (spatial.spatial_program, spatial.spatial_program_segmented):
        mode = _HostTraffic()
        _watch(monkeypatch, mode)
        with mode:
            program(prev, curr, mesh.devices, cfg, *prev.shape[1:])
        assert mode.uploads == [], program
        assert mode.reads == 0, program


def test_compiled_spatial_step_equals_its_eager_body():
    """Over slots that all name one device `make_spatial_pipeline` is the
    compiled band program (its body on the CPU), equal to the eager step
    and to the 1x1 step; its key separates meshes of another shape, and a
    mesh over two devices gets the segmented program."""
    prev, curr = _spatial_pairs()
    H, W = prev.shape[1:]
    cfg = GMEConfig(search_impl="volume")
    assert isinstance(spatial.spatial_program_jit, C.Compiled)
    one = tgme.gme_pipeline_batch(prev, curr, cfg)
    for data, space in ((1, 4), (2, 2)):
        mesh = make_mesh(data, space, ["cpu"] * (data * space))
        got = spatial.make_spatial_pipeline(mesh, cfg, H, W)(prev, curr)
        want = spatial.make_spatial_pipeline_eager(mesh, cfg, H, W)(prev, curr)
        assert set(got) == set(want) == set(one)
        for k in want:
            assert torch.equal(got[k], want[k]) and torch.equal(got[k], one[k]), (data, space, k)
    assert len(spatial.spatial_program_jit.entries) == 0
    keys = [spatial.spatial_program_jit.key(prev, curr, make_mesh(d, s, ["cpu"] * 4).devices,
                                            cfg, H, W) for d, s in ((1, 4), (2, 2), (4, 1))]
    assert len(set(keys)) == 3
    assert spatial._program_for(make_mesh(2, 2, ["cpu"] * 4)) is spatial.spatial_program_jit
    two = make_mesh(1, 2, ["cpu", "meta"])
    assert spatial._program_for(two) is spatial.spatial_program_segmented
    with pytest.raises(ValueError, match="must divide"):
        spatial.make_spatial_pipeline(make_mesh(2, 2, ["cpu"] * 4), cfg, H, W)(prev[:1], curr[:1])


@pytest.mark.parametrize("data,space,steps", [(1, 2, 16), (1, 4, 16), (2, 2, 31)])
def test_segmented_spatial_program_counts_its_steps(data, space, steps):
    """The segmented band program on the CPU runs its split session, which
    captures nothing there: the diamond step makes `steps` collective steps
    (scatter; 2 pyramid levels x 2 frames; dense init: halos, psum; each of
    2 levels: halos, error gather, moments psum; the previous frame's
    gather; the SSE and edge-hit psum; the outputs' gather; each data shard
    its own), a segment before each and after the last, and equals the
    eager program and the 1x1 step.  Every device fits its own copy of the
    parameters, so no step sends them out again."""
    prev, curr = _spatial_pairs(B=2)
    H, W = prev.shape[1:]
    cfg = GMEConfig(search_impl="volume")
    mesh = make_mesh(data, space, ["cpu"] * (data * space))
    got = spatial.spatial_program_segmented(prev, curr, mesh.devices, cfg, H, W)
    entry = spatial.spatial_program_segmented.last_entry
    assert len(entry.steps) == steps
    assert len(entry.graphs) == steps + 1 - (data - 1)  # the shards' scatters are one step
    assert all(s.copies for s in entry.steps)
    assert all(g.graph is None for g in entry.graphs)
    want = spatial.make_spatial_pipeline_eager(mesh, cfg, H, W)(prev, curr)
    one = tgme.gme_pipeline_batch(prev, curr, cfg)
    for k in want:
        assert torch.equal(got[k], want[k]) and torch.equal(got[k], one[k]), k


def test_spatial_step_sends_nothing_back_out(monkeypatch):
    """`spatial_gme_step` calls neither `broadcast` nor `scatter_rows`: every
    device fits its own parameters and builds its own fields from them, so
    only the band program's inputs are broadcast or scattered."""
    called = []

    def refuse(name):
        def call(*args, **kw):
            called.append(name)
            raise AssertionError(f"spatial_gme_step called {name}")
        return call

    prev, curr = _spatial_pairs()
    H, W = prev.shape[1:]
    bands = [[x[:, k * 16:(k + 1) * 16] for k in range(4)] for x in (prev, curr)]
    for name in ("broadcast", "scatter_rows"):
        monkeypatch.setattr(spatial, name, refuse(name))
    for procedure in (DIAMOND, THREESTEP, EXHAUSTIVE):
        spatial.spatial_gme_step(*bands, GMEConfig(searching_procedure=procedure), H, W)
    assert called == []


def _recording_transfer(moves_made):
    """A stand-in for `utils.compiled.transfer` over bands on `cpu` and
    `meta`: it records each call's (source tensor, target device) moves and
    moves the values, keeping the host values behind each meta tensor (a
    meta tensor holds none) so that a copy moved back to the CPU has them;
    a meta tensor computed on `meta` comes back as zeros."""
    host = {}  # id of a meta tensor -> (the meta tensor, its values)

    def values(t):
        if t.device.type != "meta":
            return t
        return host[id(t)][1] if id(t) in host else torch.zeros(t.shape, dtype=t.dtype)

    def transfer(moves):
        moves_made.append([(t, d) for t, d in moves])
        out = []
        for t, d in moves:
            v = values(t)
            if d.type == "meta":
                m = v.to("meta")
                host[id(m)] = (m, v)
                out.append(m)
            else:
                out.append(v.clone())
        return out

    return transfer, values, host


def test_psum_and_all_gather_deliver_to_every_device(monkeypatch):
    """As `lax.psum` and `lax.all_gather` do, `psum` and the errors'
    `all_gather` leave their result on every device of the bands: over four
    bands on `cpu`, `cpu`, `meta`, `meta`, each device is a target of the
    one transfer and receives every band's part but the one it starts from,
    so each adds up the same sum (a tuple of parts too); every band's
    errors reach both devices, and each device makes its own bands'
    inlier masks."""
    moves = []
    transfer, values, host = _recording_transfer(moves)
    monkeypatch.setattr(spatial, "transfer", transfer)
    cpu, meta = torch.device("cpu"), torch.device("meta")
    rng = np.random.RandomState(5)
    devs = [cpu, cpu, meta, meta]

    def on(d, v):
        if d == cpu:
            return v
        m = v.to("meta")
        host[id(m)] = (m, v)
        return m

    sums = [torch.from_numpy(rng.randint(-99, 99, (2, 12))) for _ in devs]
    hits = [torch.from_numpy(rng.randint(0, 9, (2,)).astype(np.int32)) for _ in devs]
    for parts, want in (([on(d, v) for d, v in zip(devs, sums)], sum(sums)),
                        ([(on(d, a), on(d, b)) for d, a, b in zip(devs, sums, hits)],
                         (sum(sums), sum(hits)))):
        moves.clear()
        got = spatial.psum(parts)
        assert list(got) == [cpu, meta] and len(moves) == 1
        flat = [p if isinstance(p, tuple) else (p,) for p in parts]
        home = {cpu: 0, meta: 2}
        for d in (cpu, meta):
            sent = [t for t, to in moves[0] if to == d]
            kept = [t for k, r in enumerate(flat) if k != home[d] for t in r]
            assert [id(t) for t in sent] == [id(t) for t in kept], d
            copy = got[d] if isinstance(got[d], tuple) else (got[d],)
            assert all(c.device == d for c in copy)
            # What the device added up: its own first part and every part sent to it.
            n = len(flat[0])
            received = [tuple(values(t) for t in flat[home[d]])] + [
                tuple(values(t) for t in sent[i:i + n]) for i in range(0, len(sent), n)]
            total = tuple(sum(col) for col in zip(*received))
            assert all(torch.equal(a, b) for a, b in zip(
                total, want if isinstance(want, tuple) else (want,))), d
        want_cpu = want if isinstance(want, tuple) else (want,)
        got_cpu = got[cpu] if isinstance(got[cpu], tuple) else (got[cpu],)
        assert all(torch.equal(a, b) for a, b in zip(got_cpu, want_cpu))

    # The errors' all_gather in the outlier rejection, on bands of 3 block rows.
    B, T, nbw = 2, 3, 5
    fields = [torch.from_numpy(rng.randint(-6, 7, (B, T, nbw, 2)).astype(np.int32)) for _ in devs]
    affine = [torch.from_numpy(rng.randint(-6, 7, (B, T, nbw, 2)).astype(np.int32))
              for _ in devs]
    valid = [torch.tensor([True, True, k < 3]) for k in range(4)]

    def groups(devices):
        out, aff = [], []
        for ks in ([0, 1], [2, 3]) if devices[2] == meta else ([0, 1, 2, 3],):
            d = devices[ks[0]]
            gb0 = torch.arange(len(ks), dtype=torch.int32)
            out.append(spatial._Field(ks, [3 * k for k in ks], on(d, gb0),
                                      on(d, torch.stack([valid[k] for k in ks])),
                                      on(d, torch.cat([fields[k] for k in ks])),
                                      on(d, torch.zeros(len(ks) * B, dtype=torch.int32))))
            aff.append(on(d, torch.cat([affine[k] for k in ks])))
        return out, aff

    moves.clear()
    masks = spatial._outlier_inliers(*groups(devs), 0.3, 4 * T * nbw)
    (gathers,) = moves
    for d in (cpu, meta):
        assert [t.shape for t, to in gathers if to == d] == [(B, T, nbw)] * 4, d
    assert [(m.device, m.shape) for m in masks] == [(cpu, (2 * B, T, nbw)),
                                                    (meta, (2 * B, T, nbw))]


def test_collective_step_groups_copies_by_device_pair():
    """A collective step runs its copies in groups by (source, target)
    device, each group's copies in order: one event pair a group between
    two devices, none within one.  The segmented band program on the CPU
    has only (cpu, cpu) groups."""
    cpu, meta = torch.device("cpu"), torch.device("meta")
    src = [torch.arange(4), torch.arange(6), torch.ones(3)]
    step = C._Step([(torch.empty(4, device="meta"), src[0]), (torch.empty(6), src[1]),
                    (torch.empty(3, device="meta"), src[2]),
                    (torch.empty(4), torch.empty(4, device="meta"))])
    groups = step.groups
    assert list(groups) == [(cpu, meta), (cpu, cpu), (meta, cpu)]
    assert [s for _, s in groups[cpu, meta]] == [src[0], src[2]]
    assert [s for _, s in groups[cpu, cpu]] == [src[1]]
    assert step.pairs == 2
    prev, curr = _spatial_pairs()
    mesh = make_mesh(1, 4, ["cpu"] * 4)
    spatial.spatial_program_segmented(prev, curr, mesh.devices, GMEConfig(), *prev.shape[1:])
    steps = spatial.spatial_program_segmented.last_entry.steps
    assert all(list(s.groups) == [(cpu, cpu)] and s.pairs == 0 for s in steps)


def test_split_session_merges_adjacent_transfers():
    """Transfers with only views between them are one step; work between
    two transfers makes a segment and a second step.  Eagerly a transfer is
    `.to`; a compiled function without `split` runs its body on the CPU."""
    def body(x):
        a = x * 2
        b, c = C.transfer([(a[:1], x.device), (a, x.device)])
        d, = C.transfer([(c[1], x.device)])  # a view of a step's result
        e = d + b[0]
        f, = C.transfer([(e, x.device)])
        return f

    x = torch.arange(6.0).reshape(2, 3)
    fn = C.compiled(body, split=True)
    assert torch.equal(fn(x), body(x))
    plan = fn.last_entry.plan
    kinds = ["step" if isinstance(i, C._Step) else "segment" for i in plan]
    assert kinds == ["segment", "step", "segment", "step"], kinds
    assert [len(s.copies) for s in fn.last_entry.steps] == [3, 1]
    assert C.transfer([(x, torch.device("cpu"))])[0] is x
    assert torch.equal(C.compiled(body)(x), body(x)) and C.compiled(body).last_entry is None


def test_only_the_collectives_move_tensors_between_devices():
    """Every `.to(`, `.copy_(` and `transfer(` of `parallel/spatial.py`
    lies inside one of its collectives: a split capture ends its graphs at
    the collectives only, so a move elsewhere would sit inside a capture."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(spatial))
    moves = {}
    for top in tree.body:
        for node in ast.walk(top):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
            if name in ("to", "copy_", "transfer"):
                moves.setdefault(getattr(top, "name", "<module>"), []).append(
                    (name, node.lineno))
    outside = {k: v for k, v in moves.items() if k not in spatial.COLLECTIVES}
    assert outside == {}, outside
    assert set(moves) <= set(spatial.COLLECTIVES)
    assert all(name == "transfer" for v in moves.values() for name, _ in v), moves
