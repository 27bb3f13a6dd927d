"""The sharded loss and gradient as a CUDA graph
(``diff.make_sharded_loss_and_grad``).

JAX jits ``value_and_grad`` of its sharded loss. On a CUDA scene over a
rank-less or NCCL mesh the port captures forward, backward and the
gradient ``psum`` in one CUDA graph, whose leaves (requiring grad) and
operands are device buffers; gloo meshes and the CPU run it eagerly, by
one predicate (``parallel.render.uses_graph``, tested here). On the CPU:

* the captured body, ``fn.captured.body``, holds no operation a capture
  refuses: its forward under ``FakeTensorMode`` on a fake CUDA device
  over the rank-less mesh (``test_torch_capture_safe.py``'s audit, with
  ``torch.autograd.grad`` stood in by zeros, and under ``no_grad``: a
  CPU-only torch aborts when autograd records a CUDA tensor, as it reads
  the tensor's stream), and its backward on real CPU tensors under the
  same refused list (``_capture_audit.BackwardAudit``); PT,
  PPM with each exchange, VCM+VM and PT through a BVH at 32^2, with
  respect to kd and the emission scale at once;
* device-tensor operands give the int form's loss and gradients bit for
  bit, per method;
* the graph route itself, run on the CPU with a stand-in whose replays
  rewrite the first run's outputs (``_capture_audit.ReplayOnCpu``),
  equals the eager route call for call as the parameters move, and
  returns gradients that the next call leaves alone.

``test_torch_grad_sharded.py`` holds the sharded gradients against the
unsharded port, finite differences and JAX's ``jit(value_and_grad)``.
"""
import types

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from _capture_audit import (CASES, BackwardAudit, CaptureAudit, ReplayOnCpu,
                            cuda_mesh, fake_cuda, scene_of, with_tables)
# the fixtures: fake CUDA indexing (autouse) and the launch stand-ins
from _capture_audit import fake_cuda_indexing, launches  # noqa: F401
from oppositerenderer_tpu_torch import capture, diff
from oppositerenderer_tpu_torch.core.rng import device_key, make_root_key
from oppositerenderer_tpu_torch.parallel import make_mesh
from oppositerenderer_tpu_torch.parallel import render as sharded
from oppositerenderer_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(2)
pytestmark = pytest.mark.filterwarnings(
    "ignore:Accessing the data pointer of FakeTensor")

SEED, IT, R2 = 3, 5, 0.0025
AUDITED = ("pt", "ppm_all_to_all", "ppm_all_gather", "vcm_vm", "bvh_pt")


def wrt_of(scene):
    """kd of material 0 and the emission scale, together."""
    return {("kd", 0): scene.materials.kd[0], ("emission_scale", -1): 1.0}


def operands(dev, tensors: bool):
    if not tensors:
        return dict(iteration=IT, key=make_root_key(SEED), radius_sq=R2)
    return dict(iteration=torch.full((), IT, dtype=torch.int64, device=dev),
                key=device_key(make_root_key(SEED), dev),
                radius_sq=torch.full((), R2, dtype=torch.float32,
                                     device=dev))


@pytest.mark.parametrize("case", AUDITED)
def test_captured_gradient_holds_no_refused_operation(case, launches,
                                                      monkeypatch):
    scene_name, make_cfg, kernels = CASES[case]
    real = with_tables(scene_name)
    cfg = make_cfg()
    # the forward, on the fake card; autograd.grad stood in by zeros
    grads_of = []
    monkeypatch.setattr(torch.autograd, "grad", lambda out, inputs, **kw: (
        grads_of.append(len(inputs)) or tuple(map(torch.zeros_like,
                                                  inputs))))
    with FakeTensorMode():
        scene, cam = fake_cuda(*real)
        mesh = cuda_mesh()
        assert sharded.uses_graph(scene, mesh)
        fn = diff.make_sharded_loss_and_grad(scene, cam, cfg, mesh,
                                             wrt_of(scene))

        def audited():   # the leaves and operands set outside
            with torch.no_grad(), CaptureAudit():
                return fn.captured.body()
        fn.captured.run = audited
        for tensors in (False, True):
            loss, grads = fn(**operands("cuda", tensors))
            assert loss.dim() == 0 and loss.device.type == "cuda"
            assert grads[("kd", 0)].shape == (3,)
    assert grads_of == [2, 2]
    assert set(launches) >= set(kernels), launches
    monkeypatch.undo()
    # the backward, on the CPU
    scene, cam, _ = real
    fn = diff.make_sharded_loss_and_grad(scene, cam, cfg,
                                         make_mesh(1, device="cpu"),
                                         wrt_of(scene))
    audit, grad = BackwardAudit(), torch.autograd.grad

    def audited_grad(*args, **kw):
        with audit:
            return grad(*args, **kw)
    monkeypatch.setattr(torch.autograd, "grad", audited_grad)
    loss, grads = fn(**operands("cpu", False))
    assert {"index_put", "where"} & audit.seen, audit.seen
    assert float(loss) > 0 and float(grads[("emission_scale", -1)]) > 0


def assert_equal(got, want):
    (loss, grads), (wloss, wgrads) = got, want
    assert torch.equal(loss, wloss)
    assert set(grads) == set(wgrads)
    for k, v in wgrads.items():
        assert torch.equal(grads[k], v), k


@pytest.mark.parametrize("case", ["pt", "ppm_all_to_all", "vcm_vm"])
def test_tensor_operands_give_the_int_forms_gradient(case):
    scene_name, make_cfg, _ = CASES[case]
    scene, cam = scene_of(scene_name)
    fn = diff.make_sharded_loss_and_grad(scene, cam, make_cfg(), make_mesh(
        1, device="cpu"), wrt_of(scene))
    assert fn.captured is None
    assert_equal(fn(**operands("cpu", True)), fn(**operands("cpu", False)))


@pytest.mark.parametrize("case", ["pt", "ppm_all_to_all"])
def test_the_graph_route_replays_the_eager_gradient(case, monkeypatch):
    """Forced onto the graph route on the CPU, through three steps of a
    descent-like loop: each call equals the eager route at its values, and
    no call rewrites an earlier call's loss or gradients."""
    monkeypatch.setattr(sharded, "uses_graph", lambda scene, mesh: True)
    monkeypatch.setattr(capture, "CapturedCall", ReplayOnCpu)
    scene_name, make_cfg, _ = CASES[case]
    scene, cam = scene_of(scene_name)
    wrt = wrt_of(scene)
    fn = diff.make_sharded_loss_and_grad(
        scene, cam, make_cfg(), make_mesh(1, device="cpu"), wrt)
    assert isinstance(fn.captured, ReplayOnCpu) and fn.eager is not fn
    kd = wrt[("kd", 0)]
    steps = [None, [kd * 0.9, 1.2], [torch.full((3,), 0.5), 0.8]]
    results, kept = [], []
    for values in steps:
        results.append(fn(values, **operands("cpu", values is None)))
        kept.append((results[-1][0].clone(),
                     {k: g.clone() for k, g in results[-1][1].items()}))
    assert fn.captured.replays == 2
    for values, got, was in zip(steps, results, kept):
        assert_equal(got, was)
        assert_equal(got, fn.eager(values, **operands("cpu", False)))
    assert not torch.equal(results[0][0], results[2][0])


def test_the_graph_route_predicate():
    """Captured on a CUDA scene over the rank-less and NCCL meshes; eager
    over gloo and on the CPU."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    group = object()
    card = types.SimpleNamespace(device=cuda)
    host = types.SimpleNamespace(device=cpu)
    rankless = Mesh(None, 0, 1, cuda, None)
    nccl = Mesh(group, 0, 2, cuda, "nccl")
    gloo = Mesh(group, 0, 2, cuda, "gloo")
    assert rankless.capturable and nccl.capturable
    assert not gloo.capturable
    assert not Mesh(group, 0, 2, cpu, "gloo").capturable
    assert sharded.uses_graph(card, rankless)
    assert sharded.uses_graph(card, nccl)
    assert not sharded.uses_graph(card, gloo)
    assert not sharded.uses_graph(host, Mesh(None, 0, 1, cpu, None))
    assert not sharded.uses_graph(host, rankless)
