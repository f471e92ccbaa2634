"""The reduction of a profiler trace: busy time as a union, kernel time as a sum, the
program's kernels told from the vendor's, idle gaps named by the host's operation."""

from types import SimpleNamespace

from pytest import approx
from torch.autograd import DeviceType

from gemmbench import devtrace


def _ev(name, start, end, device):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def test_program_kernels_are_told_from_the_vendors():
    assert devtrace.is_program_kernel(
        "void tl2wg::tl2_wgmma_kernel<128, 128, false>(CUtensorMap_st)")
    assert devtrace.is_program_kernel("void tl2_splitk_reduce_kernel(float const*, int)")
    assert not devtrace.is_program_kernel("nvjet_tst_128x64_64x8_4x1_v_bz_splitK_NNT")
    assert not devtrace.is_program_kernel(
        "void cublasLt::splitKreduce_kernel<32, 16, int, float>(x)")


def test_busy_kernel_and_gaps_by_hand():
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [
        _ev("void tl2wg::tl2_wgmma_kernel<64>(x)", 0, 100, cuda),
        _ev("nvjet_gemm", 50, 150, cuda),          # overlaps: busy is the union
        _ev("nvjet_gemm", 400, 500, cuda),
        _ev("void tl2wg::tl2_wgmma_kernel<64>(x)", 520, 600, cuda),
        _ev("cudaDeviceSynchronize", 140, 260, cpu),
        _ev("aten::mm", 300, 380, cpu),
    ]
    t = devtrace.reduce(events)
    assert t["window_s"] == approx(600e-6)  # the first device event's start to the last end
    # busy [0, 150] + [400, 500] + [520, 600]; kernels 100 + 100 + 100 + 80 us
    assert t["busy_s"] == approx(330e-6) and t["kernel_s"] == approx(380e-6)
    assert t["program_kernel_s"] == approx(180e-6) and t["device_events"] == 4
    assert t["device_ops"][0] == ["nvjet_gemm", approx(200e-6)]
    # the gap 150..400 has its middle at 275, where no host op runs; 500..520 is the other
    assert t["idle_gaps"] == [["python", approx(250e-6)], ["python", approx(20e-6)]]
    # the grid's gate is neither busy time nor kernel time, and the window is the device's
    events.append(_ev("void at::cuda::(anonymous namespace)::spin_kernel(long)", 600, 900,
                      cuda))
    events.append(_ev("cudaLaunchKernel", 890, 1000, cpu))
    t = devtrace.reduce(events)
    assert t["window_s"] == approx(600e-6) and t["busy_s"] == approx(330e-6)
    assert t["kernel_s"] == approx(380e-6) and t["device_events"] == 4
    events.append(_ev("cudaLaunchKernel", 270, 280, cpu))
    assert devtrace.reduce(events)["idle_gaps"][0] == ["cudaLaunchKernel",
                                                              approx(250e-6)]


def test_without_device_events_the_window_is_the_hosts():
    t = devtrace.reduce([_ev("aten::mm", 10, 70, DeviceType.CPU)])
    assert t["window_s"] == approx(60e-6) and t["busy_s"] == 0
