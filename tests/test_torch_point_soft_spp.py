"""The functions the point-light penumbra kernels compute, at sample counts
their (ray, sample) grouping must handle. Mode PSOFT and mode ANY_PSOFT run
one CUDA thread per (ray, sample), a block's 128 rays x spp samples in a
flat loop, so spp values that do not divide a warp (3, 33) and one above a
block's rays (130) each group the samples differently; the kernels must
equal their plain versions on every spp, which these tests hold:

- spp 3 against the JAX package's interpret-mode
  ``trace_closest_point_soft_shadow_pallas`` and
  ``trace_any_point_soft_pallas`` with the zero stream (teapot 1500,
  64x32, leaf 8; one module fixture), and the attrs=0 and attrs=2 plain
  versions against the attrs=1 one;
- spp 33 and 130, plain versions only: zero-stream counts are spp x the
  hard occlusion toward the light's centre, real-stream counts lie in
  [0, spp], show a penumbra and differ from spp 8's.

Tolerances: those of tests/test_torch_soft_shadow.py against the JAX
package (counts off on at most 1e-3 of valid pixels, biased origins on a
shadow boundary where the reference's FMA-contracted products round
differently). Within the port everything is exact: a zero-stream disk
sample is the ray toward the centre, bit for bit, and the attrs variants
walk the same shadow rays.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpurt.kernels.traverse import (trace_any_point_soft_pallas,
                                    trace_closest_point_soft_shadow_pallas)
from tpurt_torch.kernels import traverse as tr

from test_torch_any_hit import hard_rays, port_gbuf
from test_torch_multi_shadow import jax_checks_off, np_channels, \
    parity_scene
from test_torch_soft_shadow import RADIUS, SEED, check_counts
from test_torch_traverse import BIAS, LIGHT_DIR, LIGHT_POS, _check_attrs, \
    _check_hits

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ["fused", "any"]
VARIANTS = ["st", "tex"]


def _fused(s, spp, zero_stream=True, **kw):
    """The fused plain version (attrs=1 with the tables, attrs=0 with
    ``attr_tables=None``) -> (channels or (t, sidx), counts, walk counts)."""
    kw.setdefault("attr_tables", s.tat)
    return tr.trace_closest_point_soft_shadow(
        s.twide, s.to, s.td, LIGHT_POS, RADIUS, spp, SEED, BIAS,
        zero_stream=zero_stream, **kw)


def _any(s, origins, valid, spp, zero_stream=True):
    return tr.trace_any_point_soft(s.twide, origins, valid, LIGHT_POS, RADIUS,
                                   spp, SEED, zero_stream=zero_stream)


def _counts(case, kind, spp, zero_stream=True):
    """(counts i32[H, W], walk counts) of the plain version of ``kind``."""
    s = case["scene"]
    if kind == "fused":
        _, cnt, walk = _fused(s, spp, zero_stream)
    else:
        cnt, walk = _any(s, case["origins"], case["valid"], spp, zero_stream)
    return cnt.numpy(), walk.numpy()


@pytest.fixture(scope="module")
def case():
    """The parity scene, its port G-buffer and biased origins, the JAX
    package's interpret-mode counts at spp 3 (zero stream), and the hard
    occlusion toward the light's centre of both walks."""
    s = parity_scene(8)
    gbuf = port_gbuf(s)
    origins = gbuf["position"] + gbuf["gnormal"] * BIAS
    jo = jnp.asarray(origins.numpy())
    jv = jnp.asarray(gbuf["valid"].numpy())
    with jax_checks_off():
        jch, jfused = trace_closest_point_soft_shadow_pallas(
            s.acc, s.o, s.d, jnp.asarray(LIGHT_POS), jnp.float32(RADIUS), 3,
            SEED, BIAS, attr_tables=s.at, interpret=True)
        jany = trace_any_point_soft_pallas(
            s.acc, jo, jv, jnp.asarray(LIGHT_POS), jnp.float32(RADIUS), 3,
            SEED, interpret=pltpu.InterpretParams())
    tch, tcnt, walk = _fused(s, 3)
    point = hard_rays(s, gbuf)["point"]
    return {
        "scene": s, "origins": origins, "valid": gbuf["valid"],
        "fused": (np_channels(jch), np.asarray(jfused),
                  {k: v.numpy() for k, v in tch.items()}, tcnt.numpy(),
                  walk.numpy()),
        "jany": np.asarray(jany),
        "hard": {
            "fused": tr.trace_closest_shadow(
                s.twide, s.to, s.td, LIGHT_DIR, BIAS, light_pos=LIGHT_POS,
                attr_tables=s.tat)[1].numpy(),
            "any": tr.trace_any(s.twide, *point)[0].numpy()}}


def test_point_soft_hits_match_pallas_spp3(case):
    _check_hits(case["fused"])


def test_point_soft_attributes_match_pallas_spp3(case):
    _check_attrs(case["fused"])


def test_point_soft_counts_match_pallas_spp3(case):
    jch, jcnt, _, tcnt, _ = case["fused"]
    check_counts(jch, jcnt, tcnt, spp=3)


def test_any_point_soft_counts_match_pallas_spp3(case):
    tcnt, walk = _counts(case, "any", 3)
    valid = case["valid"].numpy()
    np.testing.assert_array_equal(walk, [0, 0])
    mism = (case["jany"] != tcnt) & valid
    assert mism.sum() <= 1e-3 * valid.sum(), f"{mism.sum()} mismatches"
    assert not tcnt[~valid].any()
    assert set(np.unique(tcnt)) <= {0, 3}
    assert (tcnt[valid] == 3).any() and (tcnt[valid] == 0).any()


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("spp", [3, 33])
def test_attrs_variants_count_as_attrs1(case, variant, spp):
    """attrs=0 (no tables: t and the sorted index) and attrs=2 (textured
    walk) run the same shadow rays: counts equal attrs=1's bit for bit,
    with the real stream too."""
    s = case["scene"]
    for zero in (True, False):
        head, cnt, walk = _fused(s, spp, zero)
        if variant == "st":
            vhead = _fused(s, spp, zero, attr_tables=None)
            assert torch.equal(vhead[0], head["t"])
            assert torch.equal(vhead[1], head["sidx"])
        else:
            vhead = _fused(s, spp, zero, textured=True)
            assert torch.equal(vhead[0]["t"], head["t"])
        assert torch.equal(vhead[-2], cnt)
        assert torch.equal(vhead[-1], walk)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("spp", [33, 130])
def test_zero_stream_counts_are_spp_times_hard(case, kind, spp):
    """A zero-stream disk sample is the ray toward the light's centre, bit
    for bit: every count is spp x the hard occlusion of the same walk
    (the fused kernel's point shadow; ``trace_any`` on the unfused pass's
    point rays, which make their origins and directions in another order,
    hence the 1e-3 allowance of test_torch_any_soft.py)."""
    cnt, walk = _counts(case, kind, spp)
    valid = case["valid"].numpy()
    np.testing.assert_array_equal(walk, [0, 0])
    assert not cnt[~valid].any()
    mism = (cnt != spp * case["hard"][kind].astype(np.int32)) & valid
    if kind == "fused":
        assert not mism.any()
    else:
        assert mism.sum() <= 1e-3 * valid.sum()
    assert (cnt[valid] == spp).any()


@pytest.mark.parametrize("kind", KINDS)
def test_real_stream_counts_spp33(case, kind):
    """The real stream at spp 33: counts in [0, 33] with a penumbra, and
    other counts than spp 8's (the samples 8..32 are drawn too)."""
    cnt, walk = _counts(case, kind, 33, zero_stream=False)
    cnt8, _ = _counts(case, kind, 8, zero_stream=False)
    valid = case["valid"].numpy()
    np.testing.assert_array_equal(walk, [0, 0])
    assert cnt.min() >= 0 and cnt.max() <= 33
    assert not cnt[~valid].any()
    assert ((cnt > 0) & (cnt < 33) & valid).any()
    assert not np.array_equal(cnt, cnt8)
    # The same pixels are fully lit or fully occluded at both counts but
    # for a few on the penumbra's edge.
    assert ((cnt == 33) != (cnt8 == 8)).sum() <= 0.05 * valid.sum()


def _csrc(name: str) -> str:
    with open(os.path.join(ROOT, "tpurt_torch", "kernels", "csrc",
                           name)) as f:
        return f.read()


def _case_body(src: str, mode: str) -> str:
    return re.search(r"case %s:(.*?)break;" % mode, src, re.S).group(1)


@pytest.mark.parametrize("src,mode,kernel", [
    ("fused_shadows.cu", "PSOFT", "psoft_kernel"),
    ("shadow_rays.cu", "ANY_PSOFT", "any_psoft_kernel")])
def test_penumbra_modes_launch_the_sample_major_kernels(src, mode, kernel):
    """One kernel per mode, no fallback: the mode's launch names only its
    (ray, sample) kernel, and the thread-per-ray templates refuse it."""
    text = _csrc(src)
    body = _case_body(text, mode)
    assert re.findall(r"(\w+)(?:<\d>)?<<<", body) == [kernel] * len(
        re.findall(r"<<<", body))
    assert f"static_assert(MODE != {mode}" in text
    assert text.count(f"{kernel}(Params P)") == 1
