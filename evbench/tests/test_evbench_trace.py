"""The trace's arithmetic: the union of device intervals, the idle gaps
and their labels, the names."""

from evbench import trace


def test_union_counts_overlaps_once():
    assert trace.union_us([]) == 0.0
    assert trace.union_us([(0, 10), (5, 15), (20, 25)]) == 20.0
    assert trace.union_us([(20, 25), (0, 10), (10, 12)]) == 17.0
    assert trace.union_us([(0, 100), (10, 20), (30, 40)]) == 100.0


def test_merged_and_gaps():
    busy = trace.merged([(5, 10), (0, 3), (8, 12), (20, 30)])
    assert busy == [(0, 3), (5, 12), (20, 30)]
    assert trace.gaps(busy, 0, 40) == [(3, 5), (12, 20), (30, 40)]
    assert trace.gaps(busy, 6, 25) == [(12, 20)]
    assert trace.gaps([], 1, 2) == [(1, 2)]


def test_gap_labelled_by_innermost_host_op():
    host = [(trace.SLICE, 0, 100), (trace.CALL, 0, 50), ("aten::item", 10, 30),
            ("cudaMemcpyAsync", 12, 28)]
    assert trace.label(host, 20) == "cudaMemcpyAsync"
    assert trace.label(host, 40) == "python in the call"
    assert trace.label(host, 70) == "python between calls"


def test_short_name_drops_signature_and_namespace():
    assert trace.short_name(
        "void (anonymous namespace)::matvec_kernel<__nv_bfloat16>(__nv_bfloat16 const*, "
        "float const*, float*, int, int, long long)") == "matvec_kernel<__nv_bfloat16>"
    assert trace.short_name("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH"


def test_slice_idle_and_names():
    host = [(trace.SLICE, 0, 100), (trace.CALL, 0, 100), ("aten::item", 60, 90)]
    device = [("void k<float>(float*)", 0, 40), ("void k<float>(float*)", 50, 60),
              ("Memset (Device)", 55, 58)]
    s = trace.Slice(0.0, 100.0, device, host, [])
    assert s.busy_us == 50.0
    assert s.by_name() == [("k<float>", 50e-6), ("Memset", 3e-6)]
    assert s.idle_by_host() == [("aten::item", 40e-6), ("python in the call", 10e-6)]
