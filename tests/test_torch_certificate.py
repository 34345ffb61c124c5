"""The port's certificate.py (spasm_tpu_torch, device="cpu") against the
JAX package's spasm_tpu.certificate: the PRNG bitstream (the committed
golden vectors and the reference's stream in every variant), certificates
created in one package and verified in the other field for field, their
text files, tampered certificates, and the Freivalds check of A == L @ U.
Tolerance 0."""

import dataclasses
import functools
import io
import json
import os

import numpy as np
import pytest

import spasm_tpu as st
from spasm_tpu import SparseGFp, field
from spasm_tpu import certificate as ref_cert
from spasm_tpu import fixtures as fx
from spasm_tpu.ops import dense as ref_dense

import spasm_tpu_torch as stt
from spasm_tpu_torch import certificate as port_cert
from spasm_tpu_torch import interop
from spasm_tpu_torch.ops import dense as port_dense

F = field(42013)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden", "prng_vectors.json")
FIELDS = ("r", "prime", "hash", "i", "j", "x", "y")


def port(A):
    return interop.sparse_from_reference(A)


def assert_cert_equal(got, want):
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, k)),
                                      np.asarray(getattr(want, k)), k)


def test_prng_matches_golden_vectors():
    with open(GOLDEN) as fh:
        data = json.load(fh)
    for case in data["cases"]:
        seed = bytes.fromhex(case["seed"])
        for variant, want in case["u32_variants_first16"].items():
            prng = port_cert.SpasmPRNG(seed, case["prime"], case["seq"],
                                       variant=variant)
            assert [prng.u32() for _ in range(len(want))] == want
        prng = port_cert.SpasmPRNG(seed, case["prime"], case["seq"])
        want = case["u32_LE_STATE_ours"]
        assert [prng.u32() for _ in range(len(want))] == want
        prng = port_cert.SpasmPRNG(seed, case["prime"], case["seq"])
        assert prng.mask == case["mask"]
        assert [prng.zzp() for _ in range(len(case["zzp_ours"]))] == \
            case["zzp_ours"]


@pytest.mark.parametrize("variant", port_cert.SpasmPRNG.VARIANTS)
@pytest.mark.parametrize("p", [3, 42013, 2147483629, 4294967291])
def test_prng_stream_matches_reference(p, variant):
    seed = bytes(range(32))
    a = port_cert.SpasmPRNG(seed, p, seq=5, variant=variant)
    b = ref_cert.SpasmPRNG(seed, p, seq=5, variant=variant)
    got = [a.zzp_vector(700).tolist(), [a.zzp() for _ in range(9)],
           a.zzp_vector(33).tolist(), a.u32()]
    want = [b.zzp_vector(700).tolist(), [b.zzp() for _ in range(9)],
            b.zzp_vector(33).tolist(), b.u32()]
    assert got == want
    s = port_cert.SpasmPRNG.simple(p, 11)
    assert s.zzp_vector(50).tolist() == \
        ref_cert.SpasmPRNG.simple(p, 11).zzp_vector(50).tolist()


def matrices():
    rng = np.random.default_rng(20)
    return {
        "random": SparseGFp.rand(F, 30, 36, 0.12, rng),
        "deficient": (SparseGFp.rand(F, 26, 5, 0.4, rng)
                      @ SparseGFp.rand(F, 5, 24, 0.4, rng)),
        "boundary": fx.simplex_boundary(9, 4),
        "mixed": fx.mixed_block_matrix(F, seed=4),
    }


@pytest.mark.parametrize("variant", ["LE-STATE", "BE-MEM"])
@pytest.mark.parametrize("name", ["random", "deficient", "boundary",
                                  "mixed"])
def test_certificate_across_packages(name, variant):
    A = matrices()[name]
    h = st.matrix_hash(A)
    assert stt.matrix_hash(port(A)) == h
    got = stt.certificate_rank_create(port(A), h, variant=variant,
                                      device="cpu")
    want = st.certificate_rank_create(A, h, variant=variant)
    assert_cert_equal(got, want)
    assert got.r == st.rank(A)
    # created in one package, verified in the other
    assert st.certificate_rank_verify(A, h, ref_cert.RankCertificate(
        **{k: getattr(got, k) for k in FIELDS}), variant=variant)
    assert stt.certificate_rank_verify(port(A), h, port_cert.RankCertificate(
        **{k: getattr(want, k) for k in FIELDS}), variant=variant)


def test_certificate_with_a_given_factorization():
    A = matrices()["mixed"]
    fact = stt.echelonize(port(A), device="cpu", L=True)
    got = stt.certificate_rank_create(port(A), fact=fact)
    want = st.certificate_rank_create(A)
    assert_cert_equal(got, want)


def test_certificate_corner_inverse_on_the_tensor_path(monkeypatch):
    # mixed_block_matrix goes dense at round 0: the certificate's two
    # solves invert its (226, 226) corner block through the RREF
    calls = []
    port_rref = port_dense._rref

    def spy(f, X, npivcols, panel, want_transform):
        calls.append((tuple(X.shape), want_transform))
        return port_rref(f, X, npivcols, panel, want_transform)

    monkeypatch.setattr(ref_dense, "rref",
                        functools.partial(ref_dense.rref, host_cutoff=0))
    monkeypatch.setattr(port_dense, "rref",
                        functools.partial(port_dense.rref, host_cutoff=0))
    monkeypatch.setattr(port_dense, "_rref", spy)
    A = matrices()["mixed"]
    got = stt.certificate_rank_create(port(A), device="cpu")
    assert_cert_equal(got, st.certificate_rank_create(A))
    assert calls == [((got.r, got.r), True)]


def test_tampered_certificates_are_refused():
    A = matrices()["random"]
    h = st.matrix_hash(A)
    cert = stt.certificate_rank_create(port(A), h, device="cpu")
    B = port(A)
    assert stt.certificate_rank_verify(B, h, cert)
    y = cert.y.copy()
    y[len(y) // 2] = F.normalize(y[len(y) // 2] + 1)
    for bad in (dataclasses.replace(cert, y=y),
                dataclasses.replace(cert, x=F.normalize(cert.x + 1)),
                dataclasses.replace(cert, r=cert.r - 1, i=cert.i[:-1],
                                    j=cert.j[:-1], x=cert.x[:-1],
                                    y=cert.y[:-1])):
        assert not stt.certificate_rank_verify(B, h, bad)
        assert not st.certificate_rank_verify(
            A, h, ref_cert.RankCertificate(
                **{k: getattr(bad, k) for k in FIELDS}))
    assert not stt.certificate_rank_verify(B, b"\0" * 32, cert)
    assert not stt.certificate_rank_verify(B, h, cert, variant="BE-MEM")


def test_certificate_files_across_packages(tmp_path):
    A = matrices()["deficient"]
    h = st.matrix_hash(A)
    got = stt.certificate_rank_create(port(A), h, device="cpu")
    want = st.certificate_rank_create(A, h)
    stt.rank_certificate_save(got, str(tmp_path / "port.txt"))
    st.rank_certificate_save(want, str(tmp_path / "ref.txt"))
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "ref.txt").read_bytes()
    loaded = stt.rank_certificate_load(str(tmp_path / "ref.txt"))
    assert_cert_equal(loaded, want)
    assert stt.certificate_rank_verify(port(A), h, loaded)
    buf = io.StringIO()
    stt.rank_certificate_save(got, buf)
    buf.seek(0)
    assert_cert_equal(st.rank_certificate_load(buf), got)


@pytest.mark.parametrize("name", ["random", "boundary", "mixed"])
def test_factorization_verify_matches_reference(name):
    A = matrices()[name]
    want = st.echelonize(A, L=True)
    got = stt.echelonize(port(A), device="cpu", L=True)
    assert stt.factorization_verify(port(A), got, seed=3)
    assert st.factorization_verify(A, want, seed=3)
    d = got.U.data.copy()
    d[0] = F.normalize(d[0] + 1)
    U_bad = stt.SparseGFp(got.field, got.U.n, got.U.m, got.U.indptr.copy(),
                          got.U.indices.copy(), d, _canonical=True)
    bad = dataclasses.replace(got, U=U_bad)
    assert not stt.factorization_verify(port(A), bad, seed=3)
    # the reference's check on the port's factorization, carried as arrays
    bad_ref = dataclasses.replace(want, U=SparseGFp(
        F, got.U.n, got.U.m, got.U.indptr.copy(), got.U.indices.copy(), d,
        _canonical=True))
    assert not st.factorization_verify(A, bad_ref, seed=3)
    with pytest.raises(ValueError, match="requires L"):
        stt.factorization_verify(port(A), stt.echelonize(port(A),
                                                         device="cpu"))
