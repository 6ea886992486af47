"""The ptxas report of a built kernel library, as chip_smoke.py reads it.

``_build.build`` keeps nvcc's ``-Xptxas -v`` output beside each library;
``_build.ptxas_report`` turns it into registers and spill bytes by kernel,
keyed by the demangled name with its template arguments.  Both demanglers'
spellings (cu++filt from the CUDA toolkit, c++filt from binutils) must give
the same key.
"""

import shutil

import pytest

from red_gym_tpu_torch.ops import _build

LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121theta_spectral_kernelI13__nv_bfloat16Lb1EEEvPKfPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121theta_spectral_kernelI13__nv_bfloat16Lb1EEEvPKfPKT_
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 127 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118theta_blend_kernelILi1E13__nv_bfloat16EEvPKT0_i' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118theta_blend_kernelILi1E13__nv_bfloat16EEvPKT0_i
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, 400 bytes cmem[0]
"""


@pytest.mark.parametrize("demangled, key", [
    ("void <unnamed>::theta_blend_kernel<(int)2, float>(const float *, int, const T2 *)",
     "theta_blend_kernel<2, float>"),
    ("void (anonymous namespace)::theta_blend_kernel<2, float>(float const*, int)",
     "theta_blend_kernel<2, float>"),
    ("void <unnamed>::theta_spectral_kernel<__nv_bfloat16, (bool)1>(const float *, const T1 *)",
     "theta_spectral_kernel<__nv_bfloat16, true>"),
    ("void <unnamed>::theta_shuffle_blend_kernel<(bool)0>(const float *, int)",
     "theta_shuffle_blend_kernel<false>"),
    ("void <unnamed>::prestep_kernel(const float *, int)", "prestep_kernel"),
])
def test_kernel_name_drops_namespace_casts_and_parameters(demangled, key):
    assert _build.kernel_name(demangled) == key


def test_ptxas_report_reads_registers_and_spills(tmp_path):
    if not (shutil.which("cu++filt") or shutil.which("c++filt")):
        pytest.skip("no demangler (cu++filt or c++filt) on this machine")
    lib = tmp_path / "theta.so"
    (tmp_path / "theta.so.log").write_text(LOG)
    assert _build.ptxas_report(str(lib)) == {
        "theta_spectral_kernel<__nv_bfloat16, true>": {"regs": 127, "spill_bytes": 20},
        "theta_blend_kernel<1, __nv_bfloat16>": {"regs": 96, "spill_bytes": 0},
    }
