"""The port's profilers (`tools/profile_step_torch.py`,
`tools/profile_trace_torch.py`) on the CPU, where no kernel runs: their pure
parts against the JAX tools' (`tools/profile_step.py`,
`tools/profile_trace.py`), read from those files' source without importing
them (they set JAX's cache and platform flags at import).

- The bucket rule on real kernel names: every `__global__` symbol of
  `csrc/*.cu` (K1-K9) as the profiler names it, cuBLAS GEMMs, torch's cat,
  copy, elementwise, reduce and index kernels, memcpy and memset: each in
  exactly one bucket, and an attribution's buckets sum to its window.
- The marginal against `profile_step.py:96-103`'s two lines on the same
  numbers.
- The JSON keys of `step_attribution` and `interactive_device_only`
  against the JAX tool's (its `xla_glue` bucket is `torch_glue` here).
- qp_iters=0, which the JAX profiler sweeps: the port's scan controller
  against JAX's at 0 iterations (the IPM's start point), and the
  per-iteration path at 0 (its clipped-LQR start); the other paths refuse
  0.
"""

import ast
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load_tool(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TRACE = load_tool("profile_trace_torch")
STEP = load_tool("profile_step_torch")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cuda_symbols():
    """(file, symbol) of every `__global__` function of the port's sources."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
    return [(f.name, m.group(1)) for f in sorted((ROOT / "ndp_nmpc_qd_tpu_torch" / "csrc")
                                                  .glob("*.cu"))
            for m in pat.finditer(f.read_text())]


SYMBOL_BUCKET = {"step_whole.cu": "step_whole_kernel", "linearize.cu": "linearize_kernel"}
LIBRARY = {
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize64x64x64_warpgroupsize1x1x1_execute_"
    "segment_k_off_kernel__5x_cublas": "mlp_matmuls",
    "nvjet_hsh_64x32_64x16_2x1_v_bz_TNT": "mlp_matmuls",
    "void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_16x16_128x2_tn_align8>"
    "(cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_16x16_128x2_tn_align8::Params)": "mlp_matmuls",
    "void splitKreduce_kernel<32, 16, int, float, float, float, float, true, false, false>"
    "(cublasSplitKParams<float>, float const*, float const*, float*, float const*, "
    "float const*, float const*, float const*, float*, void*, long, float*, int*)": "mlp_matmuls",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy_aligned16_contig<at::native::"
    "(anonymous namespace)::OpaqueType<4u>, unsigned int, 4, 128, 1>(...)": "layout_copies",
    "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::"
    "direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::operator()() const::"
    "{lambda()#10}::operator()() const::{lambda(float)#1}>(at::TensorIteratorBase&, ...)":
        "layout_copies",
    "Memcpy DtoD (Device -> Device)": "layout_copies",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
    "std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)":
        "torch_glue",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::"
    "func_wrapper_t<float, at::native::sum_functor<float, float, float>::operator()"
    "(at::TensorIterator&)::{lambda(float, float)#1}>, unsigned int, float, 4, 4> >(...)":
        "torch_glue",
    "void at::native::index_elementwise_kernel<128, 4, at::native::gpu_index_kernel<...> >(...)":
        "torch_glue",
    "Memset (Device)": "torch_glue",
}


def test_every_kernel_symbol_of_the_port_is_found():
    names = {s for _, s in cuda_symbols()}
    assert {"step_whole_kernel", "ipm_whole_kernel", "linearize_kernel",
            "riccati_backward_kernel", "riccati_forward_kernel", "riccati_sweep_backward_kernel",
            "riccati_sweep_forward_kernel", "riccati_packed_backward_kernel",
            "riccati_packed_forward_kernel"} <= names, names


@pytest.mark.parametrize("src, symbol", cuda_symbols())
def test_each_port_kernel_lands_in_its_bucket(src, symbol):
    """K1 -> step_whole_kernel, K3 -> linearize_kernel, K2 and the sweeps
    K4-K9 -> ipm_kernel, in the forms a profiler prints them."""
    want = SYMBOL_BUCKET.get(src, "ipm_kernel")
    for name in (symbol, f"void {symbol}<float>(ndp::StepPtrs, ndp::StepConsts, long long)",
                 f"{symbol}(ndp::IterPtrs, ndp::StepConsts, long long, int)"):
        assert TRACE.bucket_of(name) == want, name


@pytest.mark.parametrize("name", list(LIBRARY))
def test_library_and_torch_kernels_land_in_their_bucket(name):
    assert TRACE.bucket_of(name) == LIBRARY[name]
    assert TRACE.bucket_of(name) in TRACE.BUCKETS and TRACE.bucket_of(name) != "idle"


def test_attribution_sums_to_the_window():
    """Every kernel in one bucket, idle the gaps of the window (overlaps
    counted once), the buckets summing to the window a tick."""
    names = [s for _, s in cuda_symbols()] + list(LIBRARY) + ["some_unknown_kernel"]
    rng = np.random.default_rng(0)
    t, kernels = 0.0, []
    for name in names:
        t += rng.uniform(0.0, 5.0)  # a gap
        d = rng.uniform(1.0, 50.0)
        kernels.append((name, t, t + d))
        t += d
    kernels.append(("Memset (Device)", kernels[3][1], kernels[3][1] + 0.5))  # inside another
    per, total, busy = TRACE.attribute(kernels, 2)
    assert set(per) == set(TRACE.BUCKETS)
    window = kernels[-2][2] - kernels[0][1]
    assert total == pytest.approx(window / 2, rel=1e-12)
    gaps = sum(b[1] - a[2] for a, b in zip(kernels[:-2], kernels[1:-1]))
    assert per["idle"] == pytest.approx(gaps / 2, rel=1e-12)
    assert busy == pytest.approx((window - gaps) / 2, rel=1e-12)
    assert sum(per.values()) == pytest.approx(total + 0.5 / 2, rel=1e-12)  # the overlap
    assert per["other"] > 0 and per["step_whole_kernel"] > 0 and per["mlp_matmuls"] > 0


def jax_lines(path, names):
    """The assignments to `names` in the JAX tool's `main`, as source."""
    tree = ast.parse((ROOT / "tools" / path).read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    return [ast.unparse(n) for n in ast.walk(main) if isinstance(n, ast.Assign)
            and isinstance(n.targets[0], ast.Name) and n.targets[0].id in names]


def test_marginal_matches_the_jax_tool():
    lines = jax_lines("profile_step.py", ("per_iter", "base"))
    assert len(lines) == 2, lines
    for results in ({0: 2.1e-3, 6: 9.3e-3, 12: 14.1e-3}, {0: 1.0, 6: 1.0, 12: 1.0},
                    {0: 4.0e-3, 6: 1.0632e-2, 12: 1.9364e-2}):
        scope = {"results": results}
        for line in lines:
            exec(line, scope)
        per_iter, base = STEP.marginal(results)
        assert per_iter == scope["per_iter"] and base == scope["base"]


def dict_keys(node):
    return {k.value for k in node.keys if isinstance(k, ast.Constant)}


def jax_schema():
    """The JAX tool's keys: its buckets (`_aggregate`), `step_attribution`,
    its `config`, and an `interactive_device_only` row."""
    tree = ast.parse((ROOT / "tools" / "profile_trace.py").read_text())
    dicts = [n for n in ast.walk(tree) if isinstance(n, ast.Dict)]
    find = lambda key: next(d for d in dicts if key in dict_keys(d))
    step = find("step_attribution").values[0]
    return {"buckets": dict_keys(find("xla_glue")), "step": dict_keys(step),
            "config": dict_keys(find("mlp_bf16")),
            "inter": dict_keys(find("meets_deadline_device"))}


def test_json_keys_match_the_jax_schema(monkeypatch):
    """The tool's own records (controllers built on the CPU; the trace
    replaced by a made-up one: no kernel runs here) carry every key of the
    JAX tool's, with `torch_glue` for `xla_glue`, and the JAX row names."""
    fake = [("step_whole_kernel(ndp::StepPtrs)", 0.0, 7.0), ("nvjet_hsh_64x32", 8.0, 9.0)]
    monkeypatch.setattr(TRACE, "capture", lambda step, carry, n_steps=5: (fake, 1.0))
    att = TRACE.step_attribution(4, dev="cpu")
    inter = TRACE.interactive(dev="cpu")
    want = jax_schema()
    assert set(att["per_component_us"]) == (want["buckets"] - {"xla_glue"}) | {"torch_glue"}
    assert want["step"] <= set(att) and want["config"] == set(att["config"])
    assert set(inter) == {"B1", "B1_pallas_whole_step", "B64", "B64_pallas_whole_step"}
    for row in inter.values():
        assert want["inter"] <= set(row)
    assert att["per_component_us"]["step_whole_kernel"] == 7.0 / TRACE.N_STEPS
    assert att["device_total_us_per_step"] == 9.0 / TRACE.N_STEPS


def test_qp_iters_zero_matches_jax():
    """qp_iters=0 (the JAX profiler's first point) is the IPM's start point:
    the scan controller against JAX's at the scan tolerances, f64, B=4;
    the per-iteration path from the clipped-LQR start runs at 0 and gives
    the same u0 here (its start is the same LQR point in the nominal
    regime); a negative count raises."""
    import jax

    from ndp_nmpc_qd_tpu.params import NdpNmpcConfig as JaxConfig
    from ndp_nmpc_qd_tpu.solver import rti as j_rti
    from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig
    from ndp_nmpc_qd_tpu_torch.solver import rti as t_rti

    cfg, jc, B = NdpNmpcConfig(), JaxConfig(), 4
    N = cfg.ocp.N_node
    rng = np.random.default_rng(0)
    xr = np.zeros((B, N + 1, 10))
    xr[..., 2], xr[..., 6] = 1.0, 1.0
    ur = np.zeros((B, N, 4))
    ur[..., 3] = cfg.vehicle.gravity
    x0 = xr[:, 0].copy()
    x0[:, 0:3] += rng.uniform(-1.0, 1.0, (B, 3))
    fd = 0.3 * rng.standard_normal((B, N + 1, 3))
    ctl_j = j_rti.make_batched_rti_controller(jc.ocp, jc.vehicle, with_disturbance=True,
                                              qp_iters=0, backend="jax")
    u_j, st_j, info_j = jax.jit(ctl_j.update)(ctl_j.reset(xr, ur), x0, xr, ur, fd)
    T = torch.tensor
    ctl_t = t_rti.make_batched_rti_controller(cfg.ocp, cfg.vehicle, with_disturbance=True,
                                              qp_iters=0, backend="jax", device="cpu")
    u_t, st_t, info_t = ctl_t.update(ctl_t.reset(T(xr), T(ur)), T(x0), T(xr), T(ur), T(fd))
    for name, g, r in (("u0", u_t, u_j), ("x_bar", st_t.x_bar, st_j.x_bar),
                       ("u_bar", st_t.u_bar, st_j.u_bar)):
        r = T(np.asarray(r))
        torch.testing.assert_close(g, r, rtol=1e-8, atol=1e-10 * max(1.0, float(r.abs().max())),
                                   msg=name)
    torch.testing.assert_close(info_t.eq_res, T(np.asarray(info_j.eq_res)), rtol=1e-8, atol=1e-12)
    np.testing.assert_array_equal(info_t.ok.numpy(), np.asarray(info_j.ok))
    ctl_p = t_rti.make_batched_rti_controller(cfg.ocp, cfg.vehicle, with_disturbance=True,
                                              qp_iters=0, warm_start=True, device="cpu")
    u_p, _, info_p = ctl_p.update(ctl_p.reset(T(xr), T(ur)), T(x0), T(xr), T(ur), T(fd))
    assert bool(info_p.ok.all())
    torch.testing.assert_close(u_p, u_t, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="qp_iters must be >= 0"):
        t_rti.make_batched_rti_controller(cfg.ocp, cfg.vehicle, qp_iters=-1, device="cpu")


@pytest.mark.parametrize("flags", [dict(whole_ipm=True), dict(packed_state=True, whole_step=True),
                                   dict(backend="pallas_packed")],
                         ids=["K2", "K1", "dense"])
def test_qp_iters_zero_only_where_it_is_held(flags):
    """qp_iters=0 is held against JAX on the scan controller and the
    per-iteration path only: the one-launch IPMs (K1, K2), which report no
    residual after no iteration, and the dense path refuse it."""
    from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig
    from ndp_nmpc_qd_tpu_torch.solver import rti as t_rti

    cfg = NdpNmpcConfig()
    with pytest.raises(ValueError, match="qp_iters=0 runs on the scan controller"):
        t_rti.make_batched_rti_controller(cfg.ocp, cfg.vehicle, qp_iters=0, device="cpu", **flags)
    t_rti.make_batched_rti_controller(cfg.ocp, cfg.vehicle, qp_iters=1, device="cpu", **flags)
