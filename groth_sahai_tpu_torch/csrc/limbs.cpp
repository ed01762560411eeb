// Host-side byte <-> limb conversion kernels (the framework's native IO path).
//
// Python-loop conversion of big batches (e.g. 2^20 scalars for an MSM) costs
// seconds; these C kernels do the same packing at memory bandwidth. Loaded
// via ctypes (see groth_sahai_tpu_torch/utils/native.py), which builds this
// file with g++ at first use; its numpy twins of each function are the plain
// versions the tests hold the library against.
//
// Layout contract (groth_sahai_tpu_torch/ops/limbs.py): host arrays are
// uint32[n_limbs, batch] of 16-bit little-endian limbs; wire bytes are
// little-endian fixed-width integers (48 bytes Fq / 32 bytes Fr).

#include <cstdint>
#include <cstring>

extern "C" {

// bytes (batch x nbytes, row-major) -> limbs (n_limbs x batch)
void bytes_to_limbs(const uint8_t* bytes, uint32_t* limbs,
                    int64_t batch, int64_t nbytes, int64_t n_limbs) {
    for (int64_t b = 0; b < batch; ++b) {
        const uint8_t* src = bytes + b * nbytes;
        for (int64_t l = 0; l < n_limbs; ++l) {
            int64_t off = 2 * l;
            uint32_t v = 0;
            if (off < nbytes) v = src[off];
            if (off + 1 < nbytes) v |= (uint32_t)src[off + 1] << 8;
            limbs[l * batch + b] = v;
        }
    }
}

// limbs (n_limbs x batch) -> bytes (batch x nbytes)
void limbs_to_bytes(const uint32_t* limbs, uint8_t* bytes,
                    int64_t batch, int64_t nbytes, int64_t n_limbs) {
    std::memset(bytes, 0, (size_t)(batch * nbytes));
    for (int64_t b = 0; b < batch; ++b) {
        uint8_t* dst = bytes + b * nbytes;
        for (int64_t l = 0; l < n_limbs; ++l) {
            uint32_t v = limbs[l * batch + b];
            int64_t off = 2 * l;
            if (off < nbytes) dst[off] = (uint8_t)(v & 0xFF);
            if (off + 1 < nbytes) dst[off + 1] = (uint8_t)((v >> 8) & 0xFF);
        }
    }
}

// w-bit windowed digit extraction for Pippenger MSM host-side planning:
// scalars as limbs (n_limbs x batch) -> digits (n_windows x batch)
void scalar_digits(const uint32_t* limbs, uint32_t* digits,
                   int64_t batch, int64_t n_limbs, int64_t window,
                   int64_t n_windows) {
    const uint32_t mask = (1u << window) - 1u;
    for (int64_t k = 0; k < n_windows; ++k) {
        int64_t lo_bit = k * window;
        int64_t limb_i = lo_bit / 16;
        int64_t off = lo_bit % 16;
        int64_t have = 16 - off;
        for (int64_t b = 0; b < batch; ++b) {
            uint32_t d = 0;
            if (limb_i < n_limbs) d = limbs[limb_i * batch + b] >> off;
            if (have < window && limb_i + 1 < n_limbs)
                d |= limbs[(limb_i + 1) * batch + b] << have;
            digits[k * batch + b] = d & mask;
        }
    }
}

}  // extern "C"
