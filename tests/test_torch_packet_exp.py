"""The packet node-step microbenchmark (B6) against the JAX package's own
kernel: ``scripts/packet_kernel_exp.py`` runs unedited in Pallas interpret
mode through ``runpy``, with ``pallas_call`` wrapped to capture the
kernel's inputs and output. ``plain_packet_steps`` (the plain version of
``csrc/packet_exp.cu``, and what the wrapper runs on the CPU) must equal
it bit for bit in every ``--variant``: a single flipped hit changes a
tile's node chain. ``fixedrow`` is held against JAX's ``scalar`` on a
table whose rows are all equal, where the row staged once and the row read
every step are the same function: the TPU variant reads a row scratch it
never writes, which the port defines as the tile's first row.
"""
import re
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from oppositerenderer_tpu_torch.accel.packet_exp_kernels import (
    SCALAR_RESULT, VARIANTS, packet_steps, plain_packet_steps)
from oppositerenderer_tpu_torch.scripts.packet_kernel_exp import main as \
    script_main
from oppositerenderer_tpu_torch.scripts.packet_kernel_exp import make_inputs

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "scripts" / "packet_kernel_exp.py"
# a direction component just below zero, which the kernel's clamp turns
# into +1e-12
TINY_NEGATIVE = -1e-13
LINE2 = re.compile(r"total \d+\.\d\d ms -> \d+\.\d ns/node-step/tile "
                   r"-> \d+\.\d{3} ns/ray/step")
SHAPES = [(4, 2, 64, False), (9, 3, 97, False), (16, 5, 1000, True)]
# JAX's fixedrow reads an unwritten scratch: its port is held otherwise
JAX_VARIANTS = [v for v in VARIANTS if v not in ("scalar", "fixedrow")]


def jax_b6(monkeypatch, steps: int, tiles: int, rows: int,
           tiny_negative: bool, variant: str = "scalar",
           equal_rows: bool = False) -> tuple[np.ndarray, ...]:
    """(table and d as the kernel saw them, best) from the JAX script's
    kernel in ``variant``; ``equal_rows`` gives every row of the table the
    values of its first."""
    real = pl.pallas_call
    captured = []

    def capturing(kernel, **kwargs):
        f = real(kernel, **kwargs)

        def call(table, o, d):
            if tiny_negative:   # tile 0's x directions, one row of lanes
                d = d.at[0, 0, 0, :].set(TINY_NEGATIVE)
            if equal_rows:
                table = jax.numpy.broadcast_to(table[:1], table.shape)
            out = f(table, o, d)
            jax.debug.callback(
                lambda tt, dd, best: captured.append(
                    (np.asarray(tt), np.asarray(dd), np.asarray(best))),
                table, d, out)
            return out
        return call

    monkeypatch.setattr(pl, "pallas_call", capturing)
    monkeypatch.setattr(sys, "argv", [
        str(SCRIPT), "--interpret", "--steps", str(steps), "--tiles",
        str(tiles), "--rows", str(rows), "--reps", "1", "--variant",
        variant])
    runpy.run_path(str(SCRIPT), run_name="__main__")
    return captured[-1]


def check_against_jax(monkeypatch, steps, tiles, rows, tiny_negative,
                      variant):
    _, d_seen, want = jax_b6(monkeypatch, steps, tiles, rows, tiny_negative,
                             variant)
    table, o, d = make_inputs(rows, tiles, "cpu")
    if tiny_negative:
        d[0, 0, 0, :] = TINY_NEGATIVE
    np.testing.assert_array_equal(d.numpy(), d_seen)
    got = plain_packet_steps(table, o, d, steps, variant)
    assert got.shape == (tiles, 8, 128)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    if variant == "dmaonly":    # no slab test: best stays at its start
        assert bool((got == 1e30).all())
    else:
        assert 0.0 < (want < 1e30).mean() < 1.0     # hits and misses both
    return got


@pytest.mark.parametrize("steps,tiles,rows,tiny_negative", SHAPES)
def test_plain_version_equals_jax_kernel_bit_for_bit(monkeypatch, steps,
                                                     tiles, rows,
                                                     tiny_negative):
    check_against_jax(monkeypatch, steps, tiles, rows, tiny_negative,
                      "scalar")


@pytest.mark.parametrize("variant", JAX_VARIANTS)
@pytest.mark.parametrize("steps,tiles,rows,tiny_negative", SHAPES)
def test_variant_plain_version_equals_jax_kernel_bit_for_bit(
        monkeypatch, steps, tiles, rows, tiny_negative, variant):
    got = check_against_jax(monkeypatch, steps, tiles, rows, tiny_negative,
                            variant)
    table, o, d = make_inputs(rows, tiles, "cpu")
    if tiny_negative:
        d[0, 0, 0, :] = TINY_NEGATIVE
    scalar = plain_packet_steps(table, o, d, steps)
    # the row's path alone: scalar's result; the others steer another chain
    assert torch.equal(got, scalar) == (variant in SCALAR_RESULT)


@pytest.mark.parametrize("steps,tiles,rows,tiny_negative", SHAPES)
def test_fixedrow_equals_jax_scalar_on_equal_rows(monkeypatch, steps, tiles,
                                                  rows, tiny_negative):
    table_seen, d_seen, want = jax_b6(monkeypatch, steps, tiles, rows,
                                      tiny_negative, equal_rows=True)
    _, o, d = make_inputs(rows, tiles, "cpu")
    if tiny_negative:
        d[0, 0, 0, :] = TINY_NEGATIVE
    np.testing.assert_array_equal(d.numpy(), d_seen)
    table = torch.tensor(table_seen)
    assert bool((table == table[:1]).all())
    got = plain_packet_steps(table, o, d, steps, "fixedrow")
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    assert 0.0 < (want < 1e30).mean() < 1.0


def test_cpu_wrapper_runs_the_plain_version_without_a_launch():
    table, o, d = make_inputs(64, 2, "cpu")
    before = packet_steps.launches
    np.testing.assert_array_equal(packet_steps(table, o, d, 5).numpy(),
                                  plain_packet_steps(table, o, d, 5).numpy())
    assert packet_steps.launches == before
    # zero steps leave every ray at its start value
    assert bool((packet_steps(table, o, d, 0) == 1e30).all())


def test_wrapper_checks_its_inputs():
    table, o, d = make_inputs(64, 2, "cpu")
    with pytest.raises(ValueError, match="float32"):
        packet_steps(table.double(), o, d, 1)
    with pytest.raises(ValueError, match="shape"):
        packet_steps(table[:, :64].contiguous(), o, d, 1)
    with pytest.raises(ValueError, match="shape"):
        packet_steps(table, o, d[:1], 1)
    strided = torch.empty((2, 3, 8, 256))[..., ::2]
    strided.copy_(d)
    with pytest.raises(ValueError, match="contiguous"):
        packet_steps(table, o, strided, 1)
    with pytest.raises(ValueError, match="rows"):
        packet_steps(table[:0], o, d, 1)
    with pytest.raises(ValueError, match="steps"):
        packet_steps(table, o, d, -1)


def test_unknown_variant_raises():
    table, o, d = make_inputs(64, 2, "cpu")
    for fn in (packet_steps, plain_packet_steps):
        with pytest.raises(ValueError, match="unknown variant"):
            fn(table, o, d, 1, "fixed_row")
    # every known variant runs; fixedrow differs from scalar on this table
    outs = {v: packet_steps(table, o, d, 5, v) for v in VARIANTS}
    assert not torch.equal(outs["fixedrow"], outs["scalar"])


def test_module_script_prints_its_two_lines_on_the_cpu():
    cmd = [sys.executable, "-m",
           "oppositerenderer_tpu_torch.scripts.packet_kernel_exp", "--cpu",
           "--steps", "4", "--tiles", "2", "--rows", "64", "--reps", "2"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=120, check=True).stdout.splitlines()
    assert out[0] == "device=cpu G=2 STEPS=4 R=64"
    assert LINE2.fullmatch(out[1]), out[1]


@pytest.mark.parametrize("variant", VARIANTS)
def test_script_prints_its_two_lines_for_every_variant(capsys, variant):
    assert script_main(["--cpu", "--steps", "4", "--tiles", "2", "--rows",
                        "64", "--reps", "2", "--variant", variant]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device=cpu G=2 STEPS=4 R=64"
    assert len(out) == 2 and LINE2.fullmatch(out[1]), out
