"""The build of the port's CUDA kernels (ops/cuda_build.py), on the CPU: the library
name hashes every csrc/ file a source includes, and ptxas's resource report
is read per kernel; tools/sass_census.py's disassembly parser. (Building
needs nvcc and runs on the card: chip_smoke.py's build phase.)"""

import importlib.util
import os

import torch

torch.set_num_threads(2)

from tendermintx_tpu_torch.ops import cuda_build

_TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools", "sass_census.py")

PTXAS = """ptxas info    : 0 bytes gmem, 2880 bytes cmem[3]
ptxas info    : Compiling entry function 'tmx_a_kernel' for 'sm_90a'
ptxas info    : Function properties for tmx_a_kernel
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, 384 bytes cmem[0]
ptxas info    : Compiling entry function 'tmx_b_kernel' for 'sm_90a'
ptxas info    : Function properties for tmx_b_kernel
    40 bytes stack frame, 36 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 128 registers, 392 bytes cmem[0]
"""


def test_poseidon_sources_include_the_params_header():
    names = [p.rsplit("/", 1)[-1] for p in cuda_build.source_files("poseidon")]
    assert names == ["poseidon.cu", "poseidon_params.cuh"]


def test_ntt_and_deep_sources_name_their_headers():
    names = lambda name: [p.rsplit("/", 1)[-1] for p in cuda_build.source_files(name)]
    assert names("ntt") == ["ntt.cu", "goldilocks.cuh"]
    assert names("deep") == ["deep.cu", "ext.cuh", "goldilocks.cuh"]
    # each library's name hashes its own sources: the extension header
    # rebuilds the DEEP kernel alone
    assert "ext.cuh" not in names("quotient") + names("ntt") + names("poseidon")


def test_ood_and_logup_sources_name_their_headers():
    names = lambda name: [p.rsplit("/", 1)[-1] for p in cuda_build.source_files(name)]
    assert names("ood") == ["ood.cu", "ext.cuh", "goldilocks.cuh"]
    assert names("logup") == ["logup.cu", "ext.cuh", "goldilocks.cuh"]
    # each has its own library, named by the hash of its own sources
    paths = {name: cuda_build.library_path(name) for name in ("ood", "logup", "deep")}
    assert len(set(paths.values())) == 3
    assert all(os.path.basename(p).startswith(f"lib{name}_") for name, p in paths.items())


def test_quotient_sources_include_the_field_header():
    names = [p.rsplit("/", 1)[-1] for p in cuda_build.source_files("quotient")]
    assert names == ["quotient.cu", "goldilocks.cuh"]
    # the Poseidon library's hash does not depend on the new header
    assert "goldilocks.cuh" not in [p.rsplit("/", 1)[-1] for p in cuda_build.source_files("poseidon")]


def test_library_hash_follows_included_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    (tmp_path / "k.cu").write_text('#include <cstdint>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("constexpr int X = 1;\n")
    (tmp_path / "unused.cuh").write_text("constexpr int Y = 1;\n")
    first = cuda_build.library_path("k")
    assert [p.rsplit("/", 1)[-1] for p in cuda_build.source_files("k")] == ["k.cu", "a.cuh", "b.cuh"]
    (tmp_path / "unused.cuh").write_text("constexpr int Y = 2;\n")
    assert cuda_build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("constexpr int X = 2;\n")
    assert cuda_build.library_path("k") != first


def test_parse_ptxas_reads_registers_and_spills():
    assert cuda_build.parse_ptxas(PTXAS) == {
        "tmx_a_kernel": {"stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 96},
        "tmx_b_kernel": {"stack": 40, "spill_stores": 36, "spill_loads": 32, "registers": 128},
    }


SASS = """
        Function : tmx_k_kernel
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                        /* 0x00000a00ff017b82 */
        /*0010*/                   IMAD.WIDE.U32 R2, R4, 0x4b, R2 ;               /* 0x0000004b04027825 */
        /*0020*/                   IADD3 R6, P0, R2, R4, RZ ;                     /* 0x0000000402067210 */
        /*0030*/                   IMAD.X R7, RZ, RZ, R3, P0 ;                    /* 0x000000ffff077224 */
        /*0040*/               @P1 BRA 0x10 ;                                     /* 0xfffffffc00c41947 */
        /*0050*/                   EXIT ;                                         /* 0x000000000000794d */
        /*0060*/                   BRA 0x60;                                      /* 0xfffffffc00fc7947 */
"""


def test_parse_sass_counts_instructions_and_loop_bodies():
    spec = importlib.util.spec_from_file_location("sass_census", _TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    got = tool.parse_sass(SASS)["tmx_k_kernel"]
    assert got["instructions"] == 7
    assert got["by_opcode"] == {"BRA": 2, "LDC": 1, "IMAD.WIDE": 1, "IADD3": 1, "IMAD": 1, "EXIT": 1}
    assert got["loops"] == [{"start": 0x10, "end": 0x40, "instructions": 4,
                             "by_opcode": {"IMAD.WIDE": 1, "IADD3": 1, "IMAD": 1, "BRA": 1}}]
