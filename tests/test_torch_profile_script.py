"""`scripts/profile_torch_slice.py`'s device-time breakdown sorts each
kernel of the port into its own class (K8 and its activation pass, K3's
merge, the conv engine's modes: K1 / K12, K2, K6's data gradient and dskip,
K7's data gradient and K9 / K11 apart, K10's
two kernels, K6's and K7's weight gradients and their slice sum included),
and its `--conv-algo` switch names the resnet-conv routes.
CPU only: the script's measurements need the card, its classifier does not."""
import importlib.util
from pathlib import Path

import pytest

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "profile_torch_slice.py"


@pytest.fixture(scope="module")
def profile():
    spec = importlib.util.spec_from_file_location("profile_torch_slice", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("kernel,cls", [
    ("void (anonymous namespace)::wino_conv_kernel(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, float const*, float const*, float*, int, int, int, int, int, int, int)", "K8 Winograd conv"),
    ("void (anonymous namespace)::wino_act_kernel(uint4 const*, float const*, float const*, uint4*, unsigned long, "
     "int, unsigned long, int)", "K8 activation pass"),
    ("void (anonymous namespace)::flash_fwd_wgmma_kernel<128>(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, float*, float*, float*, float*, int, int, float, int)", "K3 flash attention"),
    ("void (anonymous namespace)::flash_fwd_wgmma_kernel<512>(CUtensorMap_st)", "K3 flash attention"),
    ("void (anonymous namespace)::flash_merge_kernel<512>(float const*, float const*, float const*, "
     "__nv_bfloat16*, float*, int, int)", "K3 key-split merge"),
    ("void (anonymous namespace)::conv_sm90_kernel<3>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, float const*, float const*, float const*, float const*, int, int, int, "
     "float*, int, int, int, int, int)", "K1/K12 resnet conv on the conv engine"),
    ("void (anonymous namespace)::conv_sm90_kernel<1>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, float const*, float const*, float const*, float const*, int, int, int, "
     "float*, int, int, int, int, int)", "K9/K11 Hopper conv engine"),
    ("void (anonymous namespace)::conv_sm90_kernel<0>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, float const*, float const*, float const*, float const*, int, int, int, "
     "float*, int, int, int, int, int)", "K9/K11 Hopper conv engine"),
    ("void (anonymous namespace)::stats_reduce_kernel(float const*, float*, int, int)", "K1/K2/K6/K8/K9 stats reduce"),
    ("void (anonymous namespace)::conv_sm90_kernel<2>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, float const*, float const*, float const*, float const*, int, int, int, "
     "float*, int, int, int, int, int)", "K6 data gradient"),
    ("void (anonymous namespace)::conv_sm90_kernel<(int)1>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, ...)", "K9/K11 Hopper conv engine"),
    ("void (anonymous namespace)::wgrad_sm90_kernel<3>(CUtensorMap_st, CUtensorMap_st, float*, int, int, int, int, "
     "int, int)", "K6 weight gradient (wgrad_sm90_kernel)"),
    ("void (anonymous namespace)::wgrad_sm90_kernel<1>(CUtensorMap_st, CUtensorMap_st, float*, int, int, int, int, "
     "int, int)", "K6 weight gradient (wgrad_sm90_kernel)"),
    ("void (anonymous namespace)::sum_slices_kernel(float4 const*, float4*, int, unsigned long)",
     "K6 weight-gradient slice sum"),
    ("void (anonymous namespace)::wgrad_sm90_kernel<2>(CUtensorMap_st, CUtensorMap_st, float*, int, int, int, int, "
     "int, int)", "K7 weight gradient (wgrad_sm90_kernel<2>)"),
    ("void (anonymous namespace)::wgrad_sm90_kernel<(int)2>(CUtensorMap_st, ...)", "K7 weight gradient"),
    ("void (anonymous namespace)::conv_sm90_kernel<4>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, float const*, float const*, float const*, float const*, int, int, int, "
     "float*, int, int, int, int, int)", "K2 sub-pixel upsample on the conv engine"),
    ("void (anonymous namespace)::conv_sm90_kernel<5>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, float const*, float const*, float const*, float const*, int, int, int, "
     "float*, int, int, int, int, int)", "K7 data gradient on the conv engine"),
    ("void (anonymous namespace)::dye_kernel(__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, "
     "__nv_bfloat16*, float*, int, int, int)", "K6/K7 dye pass and partial reduces"),
    ("void (anonymous namespace)::conv_sm90_kernel<6>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, float const*, float const*, float const*, float const*, int, int, int, "
     "float*, int, int, int, int, int, int)", "K6 dskip on the conv engine"),
    ("void (anonymous namespace)::flash_dq_kernel<128>(...)", "K4 attention dQ"),
    ("void (anonymous namespace)::flash_dq_kernel(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, float const*, float const*, int, int, float)", "K4 attention dQ"),
    ("void (anonymous namespace)::flash_dkv_kernel(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*, float const*, int, int, float)",
     "K5 attention dK/dV"),
    ("void (anonymous namespace)::int8_wgmma_kernel<256>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "float const*, float const*, int, int, int)", "K10 int8 matmul (int8_wgmma_kernel)"),
    ("void (anonymous namespace)::int8_wgmma_kernel<128>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "float const*, float const*, int, int, int)", "K10 int8 matmul (int8_wgmma_kernel)"),
    ("void (anonymous namespace)::int8_gemv_kernel<float, 1>(float const*, signed char const*, float const*, "
     "float const*, float*, int, int, int)", "K10 int8 matmul, skinny"),
    ("void (anonymous namespace)::int8_gemv_kernel<__nv_bfloat16, 8>(__nv_bfloat16 const*, signed char const*, "
     "float const*, float const*, __nv_bfloat16*, int, int, int)", "K10 int8 matmul, skinny"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "cuBLAS GEMM/GEMV"),
    ("void at::native::vectorized_elementwise_kernel<4>(...)", "PyTorch elementwise/copy/reduce"),
])
def test_breakdown_puts_each_kernel_in_its_class(profile, kernel, cls):
    result = profile.kernel_breakdown([{"name": kernel, "ts": 0.0, "dur": 5.0}])
    hit = [c for c in result["classes"] if c["launches"]]
    assert len(hit) == 1 and hit[0]["class"].startswith(cls)
    assert result["idle_share"] == 0.0


def test_conv_algo_switch_refuses_unknown_routes(profile, monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["profile_torch_slice.py", "--what", "train", "--conv-algo", "direct,fft"])
    with pytest.raises(SystemExit):
        profile.main()
    assert "--conv-algo" in capsys.readouterr().err
