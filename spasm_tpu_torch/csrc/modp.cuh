// Exact balanced reduction mod p on the device, shared by the kernels.
#pragma once
#include <stdint.h>

// Balanced residue of x mod p, in [-(p-1)/2, (p-1)/2] for odd p: the
// representation of spasm_tpu/field.py.  The quotient comes from a double
// multiply; the int64 multiply-subtract is exact.  Precondition
// |x| / p < 2**50: three roundings of relative size 2**-53 put the rounded
// double quotient within 0.5 + 0.375 of x / p, so |x - q*p| < p and one
// conditional fold lands in the balanced range.
// Every caller passes |x| <= 2 (p/2)**2 + p or |x| < 2**31, so
// |x| / p < 2**32.
__device__ __forceinline__ long long bal_reduce(long long x, long long p,
                                                double dinv) {
    long long q = __double2ll_rn(static_cast<double>(x) * dinv);
    long long r = x - q * p;
    const long long half = p >> 1;
    if (r > half) r -= p;
    else if (r < -half) r += p;
    return r;
}

// The same residue for |x| < 2**51 and p < 2**31, as an int, without a
// conversion instruction (the SM's slowest pipe).  Bits 0x4338000000000000
// + x are the double 1.5 * 2**52 + x, exactly, so one subtraction gives x as
// a double; one fused multiply-add onto 1.5 * 2**52 rounds x * dinv to the
// nearest integer q (|x * dinv| < 2**51), whose low word sits in the
// result's low word; q is within 0.5 + 2**-2 of x / p, so x - q p, computed
// in 32 bits (it fits), needs one conditional fold.
__device__ __forceinline__ int bal_reduce_fma(long long x, int p,
                                              double dinv) {
    const double d = __longlong_as_double(0x4338000000000000LL + x)
        - 6755399441055744.0;
    const int q = __double2loint(fma(d, dinv, 6755399441055744.0));
    int r = static_cast<int>(x) - q * p;
    const int half = p >> 1;
    if (r > half) r -= p;
    else if (r < -half) r += p;
    return r;
}
