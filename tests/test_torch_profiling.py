"""The measurement tools' shared helpers (``profiling.py``) on the CPU: the
profiled window's busy arithmetic on hand-made device events, the kernel
groups of device ops the benchmark's traces name, and the timer."""

import time

import pytest

from handwriting_line_generation_tpu_torch import profiling
from test_torch_threads import one_thread  # noqa: F401 (autouse)

NS = 1e-6                  # ms per ns


def test_window_counts_work_not_annotations():
    """Two overlapping kernels and a memcpy count as the union of their
    intervals; a ``gpu_user_annotation`` range over all of them and the
    gap between them counts as no work at all."""
    events = [("kernel", 100, 300, "void conv_kernel<float>"),
              ("kernel", 200, 400, "void at::native::reduce_kernel<512>"),
              ("gpu_memcpy", 600, 700, "Memcpy HtoD (Pageable -> Device)"),
              ("gpu_user_annotation", 50, 900, "recon.request")]
    win = profiling.window(events, 0, 1000)
    assert win["wall_ms"] == pytest.approx(1000 * NS)
    assert win["busy_ms"] == pytest.approx(400 * NS)
    assert win["idle_share"] == pytest.approx(0.6)
    assert 0.0 <= win["idle_share"] <= 1.0
    assert "recon.request" not in win["kernels_ms"]
    assert win["kernels_ms"]["void conv_kernel<float>"] == \
        pytest.approx(200 * NS)
    assert win["groups_ms"] == pytest.approx(
        {"conv": 200 * NS, "reduce": 200 * NS, "copy/cast": 100 * NS})


def test_window_clips_to_its_bounds_and_divides_by_calls():
    """Work outside the window is cut off at its bounds, and every time is
    per call of the ``n`` in the window."""
    events = [("kernel", -50, 50, "a"), ("concurrent_kernel", 80, 120, "b"),
              ("gpu_memset", 150, 250, "Memset (Device)"),
              ("kernel", 300, 400, "late")]
    win = profiling.window(events, 0, 200, n=2)
    assert win["wall_ms"] == pytest.approx(100 * NS)
    assert win["busy_ms"] == pytest.approx(70 * NS)   # (50 + 40 + 50) / 2
    assert win["idle_share"] == pytest.approx(0.3)
    assert win["kernels_ms"] == pytest.approx(
        {"a": 25 * NS, "b": 20 * NS, "Memset (Device)": 25 * NS})


# device-op names of the benchmark's traced windows (PERF_LEDGER.jsonl,
# the breakdowns of PR 21) and of the training profilers' kernels
@pytest.mark.parametrize("name, group", [
    ("void__anonymous_namespace_::epilogue_kernel___nv_bfloat16__8__tr",
     "gen_epilogue"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "conv"),
    ("sm90_xmma_dgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwck",
     "conv"),
    ("sm80_xmma_fprop_implicit_gemm_tf32f32_tf32f32_f32_nhwckrsc_nchw_",
     "conv"),
    ("void_cudnn::engines_precompiled::nchwToNhwcKernel_float__float__",
     "conv"),
    ("std::enable_if_true__void_::type_internal::gemvx::kernel_int__in",
     "matmul/bmm"),
    ("void_at::native::reduce_kernel_128__4__at::native::ReduceOp_floa",
     "reduce"),
    ("void_at::native::vectorized_elementwise_kernel_4__at::native::Bi",
     "elementwise"),
    ("void_at::native::_anonymous_namespace_::max_pool_forward_nhwc_fl",
     "pool"),
    ("void_at::native::_anonymous_namespace_::replication_pad_forward_",
     "other"),
    ("void at::native::CatArrayBatchedCopy<float, unsigned int, 4, 64>",
     "copy/cast"),
    ("void ctc_kernel<true>(float const*, int const*)", "ctc kernel"),
    ("void at::native::multi_tensor_apply_kernel<TensorListMetadata<4>>",
     "adam"),
])
def test_kernel_group(name, group):
    assert profiling.kernel_group(name) == group


class _Event:
    def __init__(self, name, flag=None):
        self._name, self._flag = name, flag
        if flag is not None:
            self.is_user_annotation = lambda: self._flag

    def name(self):
        return self._name


@pytest.mark.parametrize("event, kind", [
    (_Event("epilogue_kernel", flag=False), "kernel"),
    (_Event("recon.request", flag=True), "gpu_user_annotation"),
    (_Event("gen.spacer#3"), "gpu_user_annotation"),
    (_Event("Memcpy DtoH"), "kernel"),
])
def test_kind_without_activity_type(event, kind):
    """Where the profiler's event has no ``activity_type``, an annotation
    is told from work by its flag, else by the ``#`` of a range's name."""
    assert profiling._kind(event) == kind


def test_event_ms_on_the_cpu():
    calls = []

    def fn():
        calls.append(1)
        time.sleep(1e-3)
    ms = profiling.event_ms(fn, iters=4, warmup=2)
    assert len(calls) == 6
    assert ms > 0.0
