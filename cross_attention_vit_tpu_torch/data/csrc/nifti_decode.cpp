// Native NIfTI-1 ingest: gunzip + header parse + MONAI-style center
// pad/crop + intensity scaling, fused in one pass.
//
// The port's copy of the JAX package's decoder (native/nifti_decode.cpp),
// with the same C ABI (nifti_decode_crop, nifti_decode_crop_batch).  One call
// takes a .nii/.nii.gz on disk to a C-order float32 (tx, ty, tz) buffer ready
// for the device, touching each voxel exactly once.  A batched entry point
// fans out over std::thread for multi-core hosts.
//
// Semantics match cross_attention_vit_tpu_torch.data.nifti.read_volume_cropped:
//   * little-endian NIfTI-1, datatypes {uint8,int16,int32,float32,float64,
//     int8,uint16,uint32};
//   * scl_slope applied as float when set (non-zero, non-NaN, not identity);
//   * crop bounds: pad = max(t-s,0) front-biased t//2, crop start
//     max(padded/2 - t/2, 0)  (MONAI SpatialPad symmetric + CenterSpatialCrop).
//
// Two variants, chosen at compile time (data/native.py builds the first
// that links):
//   g++ -O3 -shared -fPIC -DNIFTI_LIBDEFLATE nifti_decode.cpp
//       -o libniftidecode.so -ldeflate -lz -lpthread
//     libdeflate gunzips the whole buffer in one shot (~2-3x faster than
//     zlib), zlib stays the fallback when the gzip ISIZE footer lies;
//   g++ -O3 -shared -fPIC nifti_decode.cpp -o libniftidecode.so -lz -lpthread
//     zlib's inflate alone, for hosts without libdeflate.
// Either way zlib reads multi-member gzip files member by member.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#ifdef NIFTI_LIBDEFLATE
#include <libdeflate.h>
#endif
#include <zlib.h>

namespace {

struct Header {
    int dims[3];
    int datatype;
    int64_t vox_offset;
    float scl_slope;
    float scl_inter;
};

int fail(char* err, size_t err_len, const std::string& msg) {
    if (err && err_len) {
        std::snprintf(err, err_len, "%s", msg.c_str());
    }
    return 1;
}

bool read_file(const char* path, std::vector<uint8_t>& out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long n = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    out.resize(static_cast<size_t>(n));
    size_t got = n ? std::fread(out.data(), 1, static_cast<size_t>(n), f) : 0;
    std::fclose(f);
    return got == static_cast<size_t>(n);
}

bool gunzip_zlib(const std::vector<uint8_t>& in, std::vector<uint8_t>& out) {
    // the gzip wrapper (16 + MAX_WBITS); after each member's end, the next
    // member (concatenated gzip streams, as Python's gzip reads them)
    z_stream s{};
    if (inflateInit2(&s, 16 + MAX_WBITS) != Z_OK) return false;
    out.clear();
    out.reserve(in.size() * 4);
    std::vector<uint8_t> buf(1 << 20);
    s.next_in = const_cast<Bytef*>(in.data());
    s.avail_in = static_cast<uInt>(in.size());
    for (;;) {
        s.next_out = buf.data();
        s.avail_out = static_cast<uInt>(buf.size());
        int ret = inflate(&s, Z_NO_FLUSH);
        if (ret != Z_OK && ret != Z_STREAM_END) {
            inflateEnd(&s);
            return false;
        }
        out.insert(out.end(), buf.data(), buf.data() + (buf.size() - s.avail_out));
        if (ret == Z_STREAM_END) {
            if (s.avail_in == 0) break;
            if (inflateReset(&s) != Z_OK) {
                inflateEnd(&s);
                return false;
            }
        } else if (s.avail_in == 0 && s.avail_out != 0) {
            inflateEnd(&s);
            return false;  // truncated stream
        }
    }
    inflateEnd(&s);
    return true;
}

#ifdef NIFTI_LIBDEFLATE
bool gunzip(const std::vector<uint8_t>& in, std::vector<uint8_t>& out) {
    // gzip stores the uncompressed size (mod 2^32) in the last 4 bytes —
    // exact for our <4 GB volumes, letting libdeflate decompress the whole
    // buffer in one shot.
    if (in.size() >= 18) {
        uint32_t isize;
        std::memcpy(&isize, in.data() + in.size() - 4, 4);
        if (isize > 0 && isize < (1u << 31)) {
            out.resize(isize);
            libdeflate_decompressor* d = libdeflate_alloc_decompressor();
            if (d) {
                size_t used = 0, actual = 0;
                libdeflate_result r = libdeflate_gzip_decompress_ex(
                    d, in.data(), in.size(), out.data(), out.size(), &used, &actual);
                libdeflate_free_decompressor(d);
                // one member that spans the whole file; a file of several
                // members (the footer is the last one's) goes to zlib
                if (r == LIBDEFLATE_SUCCESS && used == in.size()) {
                    out.resize(actual);
                    return true;
                }
            }
        }
    }
    return gunzip_zlib(in, out);  // multi-member / lying-footer fallback
}
#else
bool gunzip(const std::vector<uint8_t>& in, std::vector<uint8_t>& out) {
    return gunzip_zlib(in, out);
}
#endif

template <typename T>
T le(const uint8_t* p) {
    T v;
    std::memcpy(&v, p, sizeof(T));
    return v;  // host assumed little-endian (x86/ARM hosts)
}

int parse_header(const uint8_t* buf, size_t n, Header* h, char* err,
                 size_t err_len) {
    if (n < 352) return fail(err, err_len, "file too short for NIfTI-1 header");
    if (le<int32_t>(buf) != 348)
        return fail(err, err_len, "not little-endian NIfTI-1 (sizeof_hdr)");
    int ndim = le<int16_t>(buf + 40);
    if (ndim != 3) return fail(err, err_len, "only 3-D volumes supported");
    for (int i = 0; i < 3; ++i) h->dims[i] = le<int16_t>(buf + 42 + 2 * i);
    h->datatype = le<int16_t>(buf + 70);
    h->vox_offset = static_cast<int64_t>(le<float>(buf + 108));
    h->scl_slope = le<float>(buf + 112);
    h->scl_inter = le<float>(buf + 116);
    const uint8_t* magic = buf + 344;
    if (std::memcmp(magic, "n+1", 3) != 0 && std::memcmp(magic, "ni1", 3) != 0)
        return fail(err, err_len, "bad NIfTI magic");
    return 0;
}

struct Bounds {
    int pad_front, src_lo, src_hi, out_lo;  // per dim
};

Bounds bounds_for(int size, int target) {
    int pad = target > size ? target - size : 0;
    int pf = pad / 2;
    int padded = size + pad;
    int start = padded / 2 - target / 2;
    if (start < 0) start = 0;
    int stop = start + target;
    Bounds b;
    b.pad_front = pf;
    b.src_lo = start - pf > 0 ? start - pf : 0;
    int hi = stop - pf;
    b.src_hi = hi < size ? hi : size;
    b.out_lo = pf - start > 0 ? pf - start : 0;
    return b;
}

template <typename T>
void fill_out(const uint8_t* data, const Header& h, const Bounds b[3],
              int tx, int ty, int tz, float fill, bool scale, float slope,
              float inter, float* out) {
    const T* src = reinterpret_cast<const T*>(data);
    const int64_t X = h.dims[0], Y = h.dims[1];
    for (int64_t i = 0; i < static_cast<int64_t>(tx) * ty * tz; ++i) out[i] = fill;
    // source is F-order (x fastest); output C-order (tx, ty, tz)
    for (int sx = b[0].src_lo; sx < b[0].src_hi; ++sx) {
        int ox = b[0].out_lo + (sx - b[0].src_lo);
        for (int sy = b[1].src_lo; sy < b[1].src_hi; ++sy) {
            int oy = b[1].out_lo + (sy - b[1].src_lo);
            float* orow = out + (static_cast<int64_t>(ox) * ty + oy) * tz
                          + b[2].out_lo;
            const T* srow = src + sx + static_cast<int64_t>(sy) * X
                            + static_cast<int64_t>(b[2].src_lo) * X * Y;
            const int64_t zstride = X * Y;
            int nz = b[2].src_hi - b[2].src_lo;
            if (scale) {
                for (int z = 0; z < nz; ++z)
                    orow[z] = static_cast<float>(srow[z * zstride]) * slope + inter;
            } else {
                for (int z = 0; z < nz; ++z)
                    orow[z] = static_cast<float>(srow[z * zstride]);
            }
        }
    }
}

int decode_buffer(const std::vector<uint8_t>& raw, int tx, int ty, int tz,
                  float fill, float* out, char* err, size_t err_len) {
    Header h;
    int rc = parse_header(raw.data(), raw.size(), &h, err, err_len);
    if (rc) return rc;

    size_t elem;
    switch (h.datatype) {
        case 2: case 256: elem = 1; break;
        case 4: case 512: elem = 2; break;
        case 8: case 768: case 16: elem = 4; break;
        case 64: elem = 8; break;
        default:
            return fail(err, err_len,
                        "unsupported datatype " + std::to_string(h.datatype));
    }
    size_t need = static_cast<size_t>(h.vox_offset) +
                  elem * h.dims[0] * h.dims[1] * h.dims[2];
    if (raw.size() < need) return fail(err, err_len, "truncated voxel data");

    bool scale = h.scl_slope != 0.0f && !std::isnan(h.scl_slope) &&
                 !(h.scl_slope == 1.0f && h.scl_inter == 0.0f);
    Bounds b[3] = {bounds_for(h.dims[0], tx), bounds_for(h.dims[1], ty),
                   bounds_for(h.dims[2], tz)};
    const uint8_t* data = raw.data() + h.vox_offset;

    switch (h.datatype) {
        case 2:   fill_out<uint8_t>(data, h, b, tx, ty, tz, fill, scale, h.scl_slope, h.scl_inter, out); break;
        case 256: fill_out<int8_t>(data, h, b, tx, ty, tz, fill, scale, h.scl_slope, h.scl_inter, out); break;
        case 4:   fill_out<int16_t>(data, h, b, tx, ty, tz, fill, scale, h.scl_slope, h.scl_inter, out); break;
        case 512: fill_out<uint16_t>(data, h, b, tx, ty, tz, fill, scale, h.scl_slope, h.scl_inter, out); break;
        case 8:   fill_out<int32_t>(data, h, b, tx, ty, tz, fill, scale, h.scl_slope, h.scl_inter, out); break;
        case 768: fill_out<uint32_t>(data, h, b, tx, ty, tz, fill, scale, h.scl_slope, h.scl_inter, out); break;
        case 16:  fill_out<float>(data, h, b, tx, ty, tz, fill, scale, h.scl_slope, h.scl_inter, out); break;
        case 64:  fill_out<double>(data, h, b, tx, ty, tz, fill, scale, h.scl_slope, h.scl_inter, out); break;
    }
    return 0;
}

bool is_gzip(const std::vector<uint8_t>& buf) {
    return buf.size() >= 2 && buf[0] == 0x1f && buf[1] == 0x8b;
}

}  // namespace

extern "C" {

// Decode one file to a (tx, ty, tz) C-order float32 buffer.  Returns 0 on
// success; nonzero with a message in err otherwise.
int nifti_decode_crop(const char* path, int tx, int ty, int tz, float fill,
                      float* out, char* err, size_t err_len) {
    std::vector<uint8_t> filebuf;
    if (!read_file(path, filebuf))
        return fail(err, err_len, std::string("cannot read ") + path);
    if (is_gzip(filebuf)) {
        std::vector<uint8_t> raw;
        if (!gunzip(filebuf, raw))
            return fail(err, err_len, std::string("gunzip failed: ") + path);
        return decode_buffer(raw, tx, ty, tz, fill, out, err, err_len);
    }
    return decode_buffer(filebuf, tx, ty, tz, fill, out, err, err_len);
}

// Batched, multithreaded decode: n files into out[n][tx*ty*tz].
// Returns 0 if every file decoded; else the 1-based index of the first
// failure (its message in err).
int nifti_decode_crop_batch(const char** paths, int n, int tx, int ty, int tz,
                            float fill, float* out, int num_threads,
                            char* err, size_t err_len) {
    if (num_threads < 1) num_threads = 1;
    std::vector<int> results(n, 0);
    std::vector<std::string> errors(n);
    const int64_t vol = static_cast<int64_t>(tx) * ty * tz;

    auto work = [&](int t) {
        char local_err[256];
        for (int i = t; i < n; i += num_threads) {
            results[i] = nifti_decode_crop(paths[i], tx, ty, tz, fill,
                                           out + i * vol, local_err,
                                           sizeof(local_err));
            if (results[i]) errors[i] = local_err;
        }
    };
    std::vector<std::thread> threads;
    for (int t = 1; t < num_threads; ++t) threads.emplace_back(work, t);
    work(0);
    for (auto& th : threads) th.join();

    for (int i = 0; i < n; ++i) {
        if (results[i]) {
            fail(err, err_len, errors[i]);
            return i + 1;
        }
    }
    return 0;
}

}  // extern "C"
