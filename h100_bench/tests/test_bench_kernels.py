"""Every profiled kernel name maps to exactly one family: the port's sixteen
kernels (PERF.md's table) by their CUDA symbols, the lm_head's library GEMM,
PyTorch's own kernels and the copies."""

import json

import pytest

from harness import spec

NAMES = {
    "void (anonymous namespace)::stream::channel_kernel<false, true, "
    "(anonymous namespace)::stream::StreamedA>((anonymous namespace)::"
    "stream::Maps, (anonymous namespace)::stream::Args)": "w4a8_gemm_channel",
    "void (anonymous namespace)::tc::channel_tc_kernel<false, true>(signed "
    "char const*, float const*, int const*, float const*, float const*, "
    "void*, int*, int, int, int, int)": "w4a8_gemm_channel",
    "void (anonymous namespace)::tc::channel_split_epilogue<false, true>(int "
    "const*, float const*, float const*, void*, int, int, int)":
        "w4a8_gemm_channel",
    "void (anonymous namespace)::stream::kernel<true, true>((anonymous "
    "namespace)::stream::Maps, (anonymous namespace)::stream::Args)":
        "w4a8_gemm_group",
    "void (anonymous namespace)::tc::requant_tc_kernel<false, true>(signed "
    "char const*, float const*, int const*, float const*, float const*, "
    "void*, int*, int, int, int, int)": "w4a8_gemm_requant",
    "void (anonymous namespace)::tc::requant_split_epilogue<false, true>(int "
    "const*, float const*, float const*, void*, int, int, int)":
        "w4a8_gemm_requant",
    "void (anonymous namespace)::stream::channel_kernel<false, true, "
    "(anonymous namespace)::stream::QuantizedX<__nv_bfloat16> >((anonymous "
    "namespace)::stream::Maps, (anonymous namespace)::stream::Args)":
        "w4a8_gemm_fused_channel",
    "void (anonymous namespace)::stream::fused_kernel<__nv_bfloat16, true, "
    "true>((anonymous namespace)::stream::Maps, (anonymous namespace)::"
    "stream::Args)": "w4a8_gemm_fused_group",
    "void (anonymous namespace)::stream::channel_kernel<true, true, "
    "(anonymous namespace)::stream::StreamedA>((anonymous namespace)::"
    "stream::Maps, (anonymous namespace)::stream::Args)": "w4a8_glu_channel",
    "void (anonymous namespace)::tc::channel_tc_kernel<true, true>(signed "
    "char const*, float const*, int const*, float const*, float const*, "
    "void*, int*, int, int, int, int)": "w4a8_glu_channel",
    "void (anonymous namespace)::stream::glu_kernel<true, true>((anonymous "
    "namespace)::stream::Maps, (anonymous namespace)::stream::Args)":
        "w4a8_glu_group",
    "void (anonymous namespace)::tc::requant_tc_kernel<true, true>(signed "
    "char const*, float const*, int const*, float const*, float const*, "
    "void*, int*, int, int, int, int)": "w4a8_glu_requant",
    "void (anonymous namespace)::write_kernel<__nv_bfloat16, 4, (anonymous "
    "namespace)::SlotDest>(__nv_bfloat16 const*, __nv_bfloat16 const*, "
    "signed char*, float*, signed char*, float*, int, int, int, "
    "(anonymous namespace)::SlotDest)": "kv_write_slot",
    "void (anonymous namespace)::write_kernel<__nv_bfloat16, 4, (anonymous "
    "namespace)::PagedDest>(__nv_bfloat16 const*, __nv_bfloat16 const*, "
    "signed char*, float*, signed char*, float*, int, int, int, "
    "(anonymous namespace)::PagedDest)": "kv_write_paged",
    "void (anonymous namespace)::scores_kernel<__nv_bfloat16, false, 7, "
    "true>(__nv_bfloat16 const*, signed char const*, float const*, int "
    "const*, int const*, (anonymous namespace)::Work, (anonymous "
    "namespace)::Geometry, int, int, int, int)": "split_decode_attention",
    "void (anonymous namespace)::pv_kernel<true, 5, false>(signed char "
    "const*, float const*, int const*, int const*, (anonymous namespace)::"
    "Work, (anonymous namespace)::Geometry, int, int, int, int)":
        "split_decode_attention",
    "void (anonymous namespace)::combine_kernel<__nv_bfloat16>(int const*, "
    "(anonymous namespace)::Work, (anonymous namespace)::Geometry, int, int, "
    "__nv_bfloat16*)": "split_decode_attention",
    "void (anonymous namespace)::flash_tc_kernel<128, __nv_bfloat16, false, "
    "false>(__nv_bfloat16 const*, signed char const*, float const*, signed "
    "char const*)": "flash_attention_slot",
    "void (anonymous namespace)::flash_tc_kernel<128, __nv_bfloat16, true, "
    "false>(__nv_bfloat16 const*, signed char const*, float const*, signed "
    "char const*)": "flash_attention_paged",
    "void (anonymous namespace)::quantize_q_kernel<128, __nv_bfloat16>("
    "__nv_bfloat16 const*, signed char*, float*, int, float)":
        "flash_quantize_q",
    "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT": "lm_head_matmul",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x256x64_"
    "warpgroupsize2x1x1_execute_segment_k_off_kernel__5x_cublas":
        "lm_head_matmul",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "BinaryFunctor<float, float, float, at::native::binary_internal::"
    "MulFunctor<float> >, std::array<char*, 3ul> >(int, at::native::"
    "BinaryFunctor<float, float, float, at::native::binary_internal::"
    "MulFunctor<float> >, std::array<char*, 3ul>)": "torch_native",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
    "at::native::MeanOps<float, float, float, float>, unsigned int, float, "
    "4, 4> >(at::native::ReduceOp<float, at::native::MeanOps<float, float, "
    "float, float>, unsigned int, float, 4, 4>)": "torch_native",
    "Memcpy HtoD (Pinned -> Device)": "copies",
    "Memset (Device)": "copies",
}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_each_name_maps_to_one_family(name):
    table = spec.kernel_families()
    fam, files = spec.family_of(name, table)
    assert fam not in ("unmapped", "ambiguous"), (fam, files)
    assert NAMES[name] in files


def test_every_port_kernel_row_has_a_file():
    rows = set()
    for p in (spec.BENCH_DIR / "kernels").glob("*.json"):
        rows.update(json.loads(p.read_text())["rows"])
    assert rows == set(range(1, 17))


def test_unknown_and_ambiguous_names_are_reported():
    assert spec.family_of("some_new_kernel", spec.kernel_families())[0] == \
        "unmapped"
    import re
    table = [("a", "gemm", re.compile("x")), ("b", "attn", re.compile("x"))]
    assert spec.family_of("x", table) == ("ambiguous", ["a", "b"])
