"""Reading a device trace: busy time, idle gaps, kernels by whole name."""

from portbench.devtrace import Summary

K1 = "void (anonymous namespace)::sell_spmv_kernel<float, signed char>(x)"
K9 = "void (anonymous namespace)::sell_cg_kernel<float, signed char>(x)"
K9S = "void (anonymous namespace)::sell_cg_split_kernel<float, signed char>(x)"


def _summary():
    device = [(K1, 100.0, 200.0), ("Memcpy DtoD", 150.0, 260.0),
              (K1, 300.0, 400.0), (K9, 500.0, 900.0),
              (K9S, 950.0, 960.0)]
    host = [("cudaLaunchKernel", 270.0, 290.0),
            ("cudaDeviceSynchronize", 400.0, 1100.0),
            ("cudaStreamSynchronize", 410.0, 480.0)]
    return Summary(device, host, window_s=1000e-6)


def test_busy_is_the_union_inside_the_window():
    s = _summary()
    assert s.start == 100.0 and s.end == 1100.0
    # [100, 260] + [300, 400] + [500, 900] + [950, 960]
    assert abs(s.busy_s - (160 + 100 + 400 + 10) * 1e-6) < 1e-12
    assert s.window_s == 1000e-6


def test_kernels_by_whole_name():
    s = _summary()
    assert s.kernel_stats(("sell_spmv_kernel",)) == (2, 200e-6)
    n, t = s.kernel_stats(("sell_cg_kernel",))
    assert n == 1 and abs(t - 400e-6) < 1e-12
    assert s.kernel_stats(("sell_cg_kernel", "sell_cg_split_kernel"))[0] == 2
    assert s.kernel_stats(("sell_spmv",)) == (0, 0.0)
    assert s.kernel_stats(()) == (0, 0.0)


def test_gaps_named_by_the_host():
    s = _summary()
    gaps = s.gaps()
    assert [(a, b) for a, b in gaps] == [(960.0, 1100.0), (400.0, 500.0),
                                         (900.0, 950.0), (260.0, 300.0)]
    b = s.breakdown()
    assert b["idle_gaps"][0] == ["cudaDeviceSynchronize", 140e-6]
    assert b["idle_gaps"][1][0] == "cudaStreamSynchronize"
    assert b["idle_gaps"][3][0] == "cudaLaunchKernel"
    assert b["device_ops"][0][0] == K9 and len(b["device_ops"]) == 4
