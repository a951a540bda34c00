"""Package rules of tfhe_tpu_torch: no JAX and nothing of tfhe_tpu inside
the port, chip_smoke.py, kernel_times.py or ptxas_report.py; entry points run on the card
unless the caller asks for the CPU; chip_smoke.py refuses to run without a
card."""

import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import tfhe_tpu_torch
import tfhe_tpu_torch.weights
from tfhe_tpu_torch import boolean, core, shortint
from tfhe_tpu_torch.device import resolve_device
from tfhe_tpu_torch.prng.generators import SecretRandomGenerator
from tfhe_tpu_torch.params import (
    BOOLEAN_TEST_PARAMETERS,
    PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST,
    PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(tfhe_tpu_torch.__file__)
SMOKE = os.path.join(ROOT, "chip_smoke.py")
KERNEL_TIMES = os.path.join(ROOT, "kernel_times.py")
PTXAS_REPORT = os.path.join(ROOT, "ptxas_report.py")


def _port_sources():
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = [d for d in dirnames if d not in ("_build", "__pycache__")]
        for f in filenames:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield SMOKE
    yield KERNEL_TIMES
    yield PTXAS_REPORT


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_reference():
    offenders = []
    for path in _port_sources():
        for mod in _imported_modules(path):
            if mod.split(".")[0] in ("jax", "jaxlib", "tfhe_tpu"):
                offenders.append((os.path.relpath(path, ROOT), mod))
    assert offenders == []


def test_port_imports_with_jax_unimportable():
    modules = sorted(
        "tfhe_tpu_torch." + os.path.relpath(p, PKG)[:-3].replace(os.sep, ".")
        .replace(".__init__", "")
        for p in _port_sources()
        if p not in (SMOKE, KERNEL_TIMES, PTXAS_REPORT))
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'tfhe_tpu'): sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {modules!r}: importlib.import_module(m.replace("
            "'tfhe_tpu_torch.__init__', 'tfhe_tpu_torch'))\n"
            "import runpy\n"
            "for f in sys.argv[1:]: runpy.run_path(f, run_name='imported')\n"
            "assert not any(k.split('.')[0] in ('jax', 'tfhe_tpu') and v "
            "for k, v in sys.modules.items())\n")
    proc = subprocess.run([sys.executable, "-c", code, SMOKE, KERNEL_TIMES,
                           PTXAS_REPORT], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot be shown")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        shortint.gen_keys(PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST, seed=1)
    with pytest.raises(RuntimeError):
        shortint.ClientKey(PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST, seed=1)
    gen = SecretRandomGenerator(1)
    for call in (lambda: core.generate_binary_lwe_secret_key(4, gen),
                 lambda: core.generate_binary_glwe_secret_key(1, 8, gen),
                 lambda: core.fill_accumulator(lambda x: x, 8, 2, 4, 1 << 60),
                 lambda: core.make_lut_glwe([0, 1, 2, 3], 8, 2, 4, 1 << 60),
                 lambda: core.trivial_lwe([1, 2], 4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_multi_bit_modules_are_among_the_checked_sources():
    # the walk above reaches the multi-bit slice's modules, and none of
    # them imports JAX or the reference
    checked = {os.path.relpath(p, ROOT) for p in _port_sources()}
    new = {"tfhe_tpu_torch/core/multibit.py",
           "tfhe_tpu_torch/ops/fused_multibit.py",
           "tfhe_tpu_torch/params/multi_bit_params.py"}
    assert new <= checked
    for rel in sorted(new):
        mods = list(_imported_modules(os.path.join(ROOT, rel)))
        assert not [m for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "tfhe_tpu")]


def test_multi_bit_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot be shown")
    p = PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST
    with pytest.raises(RuntimeError, match="device='cpu'"):
        shortint.gen_keys(p, seed=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfhe_tpu_torch.weights.server_key_from_reference(
            p, np.zeros((8, 4, 1, 2, 2, 256), np.uint64),
            np.zeros((256, 5, 17), np.uint64))
    cks, sks = shortint.gen_keys(p, seed=1, device="cpu")
    assert sks.device == torch.device("cpu") and sks.is_multi_bit


def test_boolean_modules_are_among_the_checked_sources():
    # the walk above reaches the boolean slice's modules, and none of them
    # imports JAX or the reference
    checked = {os.path.relpath(p, ROOT) for p in _port_sources()}
    new = {"tfhe_tpu_torch/boolean/__init__.py",
           "tfhe_tpu_torch/params/boolean_params.py",
           "tfhe_tpu_torch/ops/fused_pbs.py"}
    assert new <= checked
    for rel in sorted(new):
        mods = list(_imported_modules(os.path.join(ROOT, rel)))
        assert not [m for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "tfhe_tpu")]


def test_boolean_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot be shown")
    p = BOOLEAN_TEST_PARAMETERS
    G, N, n = p.glwe_size, p.polynomial_size, p.lwe_dimension
    with pytest.raises(RuntimeError, match="device='cpu'"):
        boolean.gen_keys(p, seed=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        boolean.ClientKey(p, seed=1)
    bsk = np.zeros((n, p.pbs_level, G, G, N), np.uint32)
    ksk = np.zeros((p.big_lwe_dimension, p.ks_level, n + 1), np.uint32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        boolean.ServerKey.from_raw(p, bsk, ksk)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfhe_tpu_torch.weights.boolean_server_key_from_reference(p, bsk, ksk)
    cks = boolean.ClientKey(p, seed=1, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        boolean.ServerKey(cks, device="cuda")
    sks = boolean.ServerKey(cks)
    assert sks.device == torch.device("cpu") and sks.mode == "scan2"


def test_shortint_slice_modules_are_among_the_checked_sources():
    # the walk above reaches the modules of the shortint op families, the
    # PBS-then-keyswitch order and the single-CTA schedules, and none of
    # them imports JAX or the reference; the new kernel sources are there
    checked = {os.path.relpath(p, ROOT) for p in _port_sources()}
    new = {"tfhe_tpu_torch/shortint/server_key.py",
           "tfhe_tpu_torch/shortint/ciphertext.py",
           "tfhe_tpu_torch/params/shortint_params.py",
           "tfhe_tpu_torch/core/multibit.py",
           "tfhe_tpu_torch/ops/fused_pbs.py",
           "tfhe_tpu_torch/weights.py"}
    assert new <= checked
    for rel in sorted(new):
        mods = list(_imported_modules(os.path.join(ROOT, rel)))
        assert not [m for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "tfhe_tpu")]
    for src in ("single_cta_kernels.cu", "ntt_core_kernels.cuh"):
        assert os.path.exists(os.path.join(PKG, "ops", "csrc", src))


def test_shortint_server_key_refuses_an_unknown_mode():
    cks = shortint.ClientKey(PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST, seed=1,
                             device="cpu")
    with pytest.raises(ValueError, match="mode"):
        shortint.ServerKey(cks, mode="bogus")
    with pytest.raises(ValueError, match="mode"):
        shortint.gen_keys(PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST,
                          seed=1, device="cpu", mode="mega")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            shortint.ServerKey(cks, device="cuda", mode="mega")


@pytest.mark.parametrize("where", ["checkout", "bare_directory"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    cwd = ROOT
    if where == "bare_directory":
        shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_ntt_slice_modules_are_among_the_checked_sources():
    # the walk above reaches the CRT-NTT layout's and the u128 torus's
    # modules, and none of them imports JAX or the reference; the K10
    # kernel's sources are there
    checked = {os.path.relpath(p, ROOT) for p in _port_sources()}
    new = {"tfhe_tpu_torch/ops/shoup_mac.py",
           "tfhe_tpu_torch/ops/polymul_ntt.py",
           "tfhe_tpu_torch/ops/u128.py",
           "tfhe_tpu_torch/core/u128_crypto.py",
           "tfhe_tpu_torch/core/pbs.py",
           "tfhe_tpu_torch/weights.py"}
    assert new <= checked
    for rel in sorted(new):
        mods = list(_imported_modules(os.path.join(ROOT, rel)))
        assert not [m for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "tfhe_tpu")]
    for src in ("shoup_mac_kernels.cu", "shoup_mac_kernels.cuh"):
        assert os.path.exists(os.path.join(PKG, "ops", "csrc", src))


def test_ntt_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot be shown")
    bsk = np.zeros((2, 1, 2, 2, 256), np.uint64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        core.prepare_bsk_ntt(bsk, 23)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        core.prepare_bsk_ntt(bsk, 23, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfhe_tpu_torch.weights.bootstrap_key_u128_from_reference(
            np.zeros((2, 1, 2, 2, 64, 2), np.uint64), 18, 2, 1, 64, 1)
    gen = SecretRandomGenerator(1)
    for call in (lambda: core.generate_binary_lwe_secret_key_u128(4, gen),
                 lambda: core.fill_accumulator_u128(lambda x: x, 64, 2, 4,
                                                    1 << 125)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    cks = shortint.ClientKey(PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST, seed=1,
                             device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        shortint.ServerKey(cks, device="cuda", mode="ntt")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        boolean.gen_keys(BOOLEAN_TEST_PARAMETERS, seed=1, mode="ntt")
    sks = shortint.ServerKey(cks, mode="ntt")
    assert sks.device == torch.device("cpu")
    assert isinstance(sks.bsk, core.PreparedBskNtt)
    assert sks.bsk.spectra.device == torch.device("cpu")


def test_integer_modules_are_among_the_checked_sources():
    # the walk above reaches the integer layer's modules, and none of them
    # imports JAX or the reference
    checked = {os.path.relpath(p, ROOT) for p in _port_sources()}
    new = {f"tfhe_tpu_torch/integer/{m}.py" for m in
           ("__init__", "ciphertext", "client_key", "server_key", "signed",
            "crt")}
    assert new <= checked
    for rel in sorted(new):
        mods = list(_imported_modules(os.path.join(ROOT, rel)))
        assert not [m for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "tfhe_tpu")]
    assert tfhe_tpu_torch.integer.gen_keys_radix is not None


def test_integer_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot be shown")
    from tfhe_tpu_torch import integer

    p = PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST
    for call in (lambda: integer.gen_keys_radix(p, 4, seed=1),
                 lambda: integer.RadixClientKey(p, 4, seed=1),
                 lambda: integer.gen_keys_crt(p, [2, 3], seed=1),
                 lambda: integer.CrtClientKey(p, [2, 3], seed=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    cks, sks = integer.gen_keys_radix(p, 4, seed=1, device="cpu")
    assert sks.key.device == torch.device("cpu") and sks.key.mode == "scan2"
    # a u64 at 32 blocks of 2 bits: values past 2^63 through Python ints
    wide = integer.RadixClientKey(p, 32, _key=cks.key)
    for v in (2**63, 2**64 - 1, 2**64 + 5):
        assert wide.decrypt(wide.encrypt(v)) == v % 2**64
    assert wide.decrypt_signed(wide.encrypt_signed(-1)) == -1


def test_schedule_and_strings_modules_are_among_the_checked_sources():
    # the walk above reaches the integer layer's single-program and batched
    # schedules and the string library, and none of them imports JAX or the
    # reference
    checked = {os.path.relpath(p, ROOT) for p in _port_sources()}
    new = {f"tfhe_tpu_torch/integer/{m}.py" for m in
           ("fused", "fused_dispatch", "batched")} | {
        f"tfhe_tpu_torch/strings/{m}.py" for m in
        ("__init__", "ciphertext", "client_key", "server_key", "split",
         "batched")}
    assert new <= checked
    for rel in sorted(new):
        mods = list(_imported_modules(os.path.join(ROOT, rel)))
        assert not [m for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "tfhe_tpu")]
    assert "strings" in tfhe_tpu_torch.__all__


def test_no_environment_variable_chooses_a_schedule():
    # the schedules are arguments: only the CUDA toolkit's location is read
    # from the environment
    reads = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Attribute) and node.attr in ("environ",
                                                                 "getenv"):
                reads.append(os.path.relpath(path, ROOT))
    assert reads == ["tfhe_tpu_torch/ops/fused_pbs.py"]
    src = open(os.path.join(PKG, "ops", "fused_pbs.py")).read()
    assert 'os.environ.get("CUDA_HOME"' in src


def test_schedules_are_arguments():
    from tfhe_tpu_torch import integer
    from tfhe_tpu_torch.integer.batched import BatchedRadixOps

    cks, sks = integer.gen_keys_radix(PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST, 4,
                                      seed=1, device="cpu")
    assert sks.fused is False
    assert integer.IntegerServerKey(sks.key, fused=True).fused is True
    for mode in ("scan", "ripple"):
        assert BatchedRadixOps(sks.key, mode).mode == mode
    for mode in ("auto", None, "Scan"):
        with pytest.raises(ValueError, match="carry schedule"):
            BatchedRadixOps(sks.key, mode)
    with pytest.raises(TypeError):
        integer.gen_keys_radix(PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST, 4,
                               seed=1, device="cpu", mode="scan1")


def test_strings_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot be shown")
    from tfhe_tpu_torch import strings

    for call in (lambda: strings.gen_keys(seed=1),
                 lambda: strings.gen_keys_test(seed=1),
                 lambda: strings.gen_keys(PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST,
                                          seed=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    cks, sks = strings.gen_keys_test(seed=1, device="cpu")
    assert sks.sks.device == torch.device("cpu")
    assert not sks.integer_key.fused
    assert cks.decrypt_string(cks.encrypt_str("ok")) == "ok"


def test_api_examples_apps_and_utils_are_among_the_checked_sources():
    # the walk above reaches the high-level API, the examples, the Trivium
    # app and the serialization errors, and none of them imports JAX or the
    # reference
    checked = {os.path.relpath(p, ROOT) for p in _port_sources()}
    new = {"tfhe_tpu_torch/api/__init__.py",
           "tfhe_tpu_torch/apps/__init__.py",
           "tfhe_tpu_torch/apps/trivium.py",
           "tfhe_tpu_torch/utils/__init__.py",
           "tfhe_tpu_torch/utils/serialization.py",
           "tfhe_tpu_torch/core/multibit.py"} | {
        f"tfhe_tpu_torch/examples/{m}.py" for m in
        ("__init__", "dark_market", "sha256_bool", "regex_engine",
         "fhe_strings_cli")}
    assert new <= checked
    for rel in sorted(new):
        mods = list(_imported_modules(os.path.join(ROOT, rel)))
        assert not [m for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "tfhe_tpu")]
    # importing the API registers its wire-format adapters and stays
    # cheap: no kernel is built and no key is made
    code = ("import tfhe_tpu_torch\n"
            "from tfhe_tpu_torch.ops import fused_pbs\n"
            "from tfhe_tpu_torch.utils import serialization as ser\n"
            "assert tfhe_tpu_torch.FheUint64.NUM_BITS == 64\n"
            "assert 'api.FheUint' in ser._FROM_STATE\n"
            "assert 'api.CompressedServerKey' in ser._FROM_STATE\n"
            "assert fused_pbs.cuda_library.cache_info().currsize == 0\n"
            "assert fused_pbs.single_cta_library.cache_info().currsize == 0\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_api_and_examples_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot be shown")
    from tfhe_tpu_torch import api, weights
    from tfhe_tpu_torch.examples import sha256_bool
    from tfhe_tpu_torch.params import (BOOLEAN_SHA_TEST_PARAMETERS,
                                       PARAM_MESSAGE_2_CARRY_2_KS_PBS)

    assert api.ConfigBuilder.default().build().parameters is \
        PARAM_MESSAGE_2_CARRY_2_KS_PBS
    config = api.ConfigBuilder.default().use_custom_parameters(
        PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST).build()
    for call in (lambda: api.generate_keys(config, seed=1),
                 lambda: api.generate_keys(config, seed=1, fused=True),
                 lambda: api.ClientKey(config, seed=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    p = PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST
    n, N = p.lwe_dimension, p.polynomial_size
    with pytest.raises(RuntimeError, match="device='cpu'"):
        weights.api_keys_from_reference(
            config, np.zeros(n, np.uint64), np.zeros((1, N), np.uint64),
            np.zeros((n, p.pbs_level, 2, 2, N), np.uint64),
            np.zeros((N, p.ks_level, n + 1), np.uint64))
    cks, sks = api.generate_keys(config, seed=1, device="cpu", fused=True)
    assert cks.radix.key.device == sks.integer_key.key.device == \
        torch.device("cpu")
    assert sks.integer_key.fused is True
    # the public, compact and compressed keys work on the CPU: encrypt,
    # then decrypt
    pk = api.PublicKey(cks)
    assert api.FheUint8.encrypt_with_public_key(77, pk).decrypt(cks) == 77
    cpk = api.CompactPublicKey(cks)
    assert api.CompactFheUint8.encrypt(12, cpk).expand().decrypt(cks) == 12
    dsks = api.CompressedServerKey(cks).decompress()
    assert dsks.integer_key.key.device == torch.device("cpu")
    api.set_server_key(dsks)
    a = api.FheUint8.encrypt(17, cks)
    assert (a + 5).decrypt(cks) == 22
    # a multi-bit key in mode "ntt" asks for the card like every mode
    mb = shortint.ClientKey(PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST,
                            seed=1, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        shortint.ServerKey(mb, device="cuda", mode="ntt")
    # the SHA-256 engine makes its words where its key lives
    _, bsks = boolean.gen_keys(BOOLEAN_SHA_TEST_PARAMETERS, seed=1,
                               device="cpu")
    word = sha256_bool.Sha256Fhe(bsks).trivial_word(0xABCD)
    assert word.device == torch.device("cpu") and word.shape[0] == 32


def test_wopbs_keys_and_wire_modules_are_among_the_checked_sources():
    # the walk above reaches WoPBS, the packing keyswitch, the public,
    # seeded and compressed keys, the casting key, the entities, the wire
    # format and the key cache, and none of them imports JAX or the
    # reference
    checked = {os.path.relpath(p, ROOT) for p in _port_sources()}
    new = {f"tfhe_tpu_torch/{m}.py" for m in (
        "core/packing_keyswitch", "core/wopbs", "core/public_key",
        "core/seeded", "shortint/wopbs", "shortint/public_key",
        "shortint/compressed", "shortint/key_switching_key",
        "integer/wopbs", "entities/__init__", "utils/serialization",
        "utils/keycache", "params/wopbs_params", "params/compact_pk_params")}
    assert new <= checked
    for rel in sorted(new):
        mods = list(_imported_modules(os.path.join(ROOT, rel)))
        assert not [m for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "tfhe_tpu")]


def test_wopbs_and_key_entry_points_need_a_card_unless_asked_for_the_cpu(
        tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot be shown")
    from tfhe_tpu_torch.params import WOPBS_PARAM_MESSAGE_2_CARRY_2_TEST
    from tfhe_tpu_torch.utils import safe_deserialize, safe_serialize

    p = PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST
    for call in (
            lambda: shortint.gen_keys_wopbs(WOPBS_PARAM_MESSAGE_2_CARRY_2_TEST,
                                            seed=1),
            lambda: shortint.gen_keys(p, seed=1, cache_dir=str(tmp_path))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    cks, sks = shortint.gen_keys(p, seed=1, device="cpu")
    data = safe_serialize(sks)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        safe_deserialize(data)
    assert safe_deserialize(data, device="cpu").device == torch.device("cpu")
    # keys made from a CPU client key stay on the CPU
    assert shortint.PublicKey(cks).key.zero_encs.device == \
        torch.device("cpu")
    assert shortint.CompactPublicKey(cks).key.mask.device == \
        torch.device("cpu")
    assert shortint.CompressedServerKey(cks).decompress().device == \
        torch.device("cpu")
    _, wsks, wk = shortint.gen_keys_wopbs(WOPBS_PARAM_MESSAGE_2_CARRY_2_TEST,
                                          seed=1, device="cpu")
    assert wk.cbs.pfpksk_list.device == torch.device("cpu")
    assert wsks.mode == "scan2"


def test_parallel_and_profiling_modules_are_among_the_checked_sources():
    # the walk above reaches the mesh layer, the checkpoints and the
    # profiling helpers, and none of them imports JAX or the reference;
    # the parallel package exports the reference's 19 names
    checked = {os.path.relpath(p, ROOT) for p in _port_sources()}
    new = {f"tfhe_tpu_torch/parallel/{m}.py" for m in
           ("__init__", "mesh", "sharding", "fused", "checkpoint")} | {
        "tfhe_tpu_torch/utils/profiling.py"}
    assert new <= checked
    for rel in sorted(new):
        mods = list(_imported_modules(os.path.join(ROOT, rel)))
        assert not [m for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "tfhe_tpu")]
    ref_init = os.path.join(ROOT, "tfhe_tpu", "parallel", "__init__.py")
    ref_all = next(
        ast.literal_eval(node.value)
        for node in ast.walk(ast.parse(open(ref_init).read()))
        if isinstance(node, ast.Assign)
        and getattr(node.targets[0], "id", None) == "__all__")
    from tfhe_tpu_torch import parallel, utils

    assert len(ref_all) == 19 and parallel.__all__ == ref_all
    assert all(callable(getattr(parallel, n)) for n in ref_all)
    assert {"OpTimer", "annotate", "trace"} <= set(utils.__all__)


def test_no_environment_variable_chooses_the_world_rank_or_backend():
    # every process group the port or the smoke starts names its world, its
    # rank and its rendezvous (tcp://, a file:// store or a private store),
    # never env://
    calls = []
    for path in _port_sources():
        src = open(path).read()
        assert "env://" not in src, path
        for node in ast.walk(ast.parse(src)):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "attr", None)
                    == "init_process_group"):
                calls.append(node)
                kws = {k.arg: k.value for k in node.keywords}
                assert {"world_size", "rank"} <= set(kws), path
                assert node.args or "backend" in kws, path
                rendezvous = kws.get("init_method", kws.get("store"))
                if isinstance(rendezvous, ast.JoinedStr):
                    assert rendezvous.values[0].value in ("tcp://",
                                                          "file://"), path
                else:
                    assert "store" in kws, path
    assert len(calls) >= 2
    # and at run time the variables torch's env:// rendezvous reads change
    # nothing: a mesh without a group is a world of one on a private store
    code = ("import torch.distributed as d\n"
            "from tfhe_tpu_torch import parallel\n"
            "m = parallel.create_mesh(device='cpu')\n"
            "assert d.get_world_size() == 1 and d.get_rank() == 0\n"
            "assert d.get_backend() == 'gloo' and m.size() == 1\n"
            "d.destroy_process_group()\n")
    env = dict(os.environ, WORLD_SIZE="4", RANK="3", LOCAL_RANK="3",
               MASTER_ADDR="127.0.0.1", MASTER_PORT="1",
               TORCH_DISTRIBUTED_BACKEND="nccl")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
