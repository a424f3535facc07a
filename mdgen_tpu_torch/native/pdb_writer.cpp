// Fast multi-MODEL PDB serialization.
//
// Trajectory PDB writing is the host-side bottleneck of the inference
// pipeline (a 100k-frame peptide trajectory is ~3M ATOM records); Python
// string formatting takes minutes, this takes seconds. All chemical
// knowledge (atom names, residue names, masks) is prepared by the Python
// caller, keeping this file pure formatting.
//
// Build: make -C native   (produces libmdgen_native.so, loaded via ctypes)

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// positions: [n_frames, n_res, 37, 3] float32
// mask:      [n_res, 37] float32 (>0.5 = atom exists)
// names4:    [37 * 4] chars, exact 4-char PDB atom-name field
// elems:     [37] chars, element symbol
// res3:      [n_res * 3] chars, 3-letter residue names
// res_index: [n_res] int32 residue numbers
// out/cap:   caller-allocated text buffer
// returns bytes written, or -1 if the buffer is too small.
int64_t mdgen_write_pdb_models(
    const float* positions, const float* mask, const char* names4,
    const char* elems, const char* res3, const int32_t* res_index,
    int64_t n_frames, int64_t n_res, char* out, int64_t cap) {
    char* p = out;
    char* end = out + cap;

    for (int64_t f = 0; f < n_frames; ++f) {
        if (end - p < 64) return -1;
        p += snprintf(p, end - p, "MODEL %lld\n", static_cast<long long>(f));
        int64_t serial = 1;
        for (int64_t r = 0; r < n_res; ++r) {
            const char* rn = res3 + r * 3;
            for (int64_t a = 0; a < 37; ++a) {
                if (mask[r * 37 + a] < 0.5f) continue;
                if (end - p < 96) return -1;
                const float* xyz = positions + ((f * n_res + r) * 37 + a) * 3;
                int n = snprintf(
                    p, end - p,
                    "ATOM  %5lld %.4s %.3s A%4d    %8.3f%8.3f%8.3f%6.2f%6.2f"
                    "          %2c\n",
                    static_cast<long long>(serial % 100000), names4 + a * 4, rn,
                    res_index[r] % 10000, static_cast<double>(xyz[0]),
                    static_cast<double>(xyz[1]), static_cast<double>(xyz[2]),
                    1.0, 0.0, elems[a]);
                if (n < 0) return -1;
                p += n;
                ++serial;
            }
        }
        if (end - p < 16) return -1;
        memcpy(p, "TER\nENDMDL\n", 11);
        p += 11;
    }
    return p - out;
}

// Gather a strided window from an fp16 atom14 memmap into a contiguous
// fp16 buffer: src[start + i*stride] for i in [0, n_out). Used by the data
// loader to avoid numpy fancy-indexing copies on the hot path.
void mdgen_gather_window_f16(const uint16_t* src, int64_t frame_elems,
                             int64_t start, int64_t stride, int64_t n_out,
                             uint16_t* dst) {
    for (int64_t i = 0; i < n_out; ++i) {
        memcpy(dst + i * frame_elems, src + (start + i * stride) * frame_elems,
               sizeof(uint16_t) * frame_elems);
    }
}

}  // extern "C"
