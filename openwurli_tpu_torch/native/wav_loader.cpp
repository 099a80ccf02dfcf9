// Native audio data loader for openwurli_tpu.
//
// The role the reference fills with Rust CLI plumbing (WAV encode/decode in
// hound, block stats in the analysis tools) is served here by a small C++
// library: RIFF/WAVE decode (PCM 16/24/32 + float32), mono mixdown, WAV
// encode, and framed RMS/peak envelopes — the hot path when the ML pipeline
// chews through long recordings. Loaded via ctypes (no pybind11 in the
// image); openwurli_tpu.io.wav and calib.notes fall back to the pure-NumPy
// implementations when the library is unavailable.
//
// Build: g++ -O2 -shared -fPIC -o libwurli_native.so wav_loader.cpp

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <cmath>
#include <vector>

extern "C" {

// Decode a WAV file. Two-phase: call with out=nullptr to get the mono
// frame count (negative = error code); then with a buffer of that size.
// Returns the number of frames written, and *sample_rate.
long long wurli_decode_wav(const char* path, double* out,
                           long long out_capacity, int* sample_rate) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::fseek(f, 0, SEEK_END);
    long long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> raw((size_t)size);
    if (std::fread(raw.data(), 1, (size_t)size, f) != (size_t)size) {
        std::fclose(f);
        return -2;
    }
    std::fclose(f);
    if (size < 44 || std::memcmp(raw.data(), "RIFF", 4) ||
        std::memcmp(raw.data() + 8, "WAVE", 4))
        return -3;

    int fmt_tag = 0, channels = 0, bits = 0, sr = 0;
    const uint8_t* data = nullptr;
    long long data_len = 0;
    size_t pos = 12;
    while (pos + 8 <= (size_t)size) {
        uint32_t csize;
        std::memcpy(&csize, raw.data() + pos + 4, 4);
        const uint8_t* body = raw.data() + pos + 8;
        if (!std::memcmp(raw.data() + pos, "fmt ", 4) && csize >= 16) {
            uint16_t tag, ch, blk, bb;
            uint32_t rate, brate;
            std::memcpy(&tag, body, 2);
            std::memcpy(&ch, body + 2, 2);
            std::memcpy(&rate, body + 4, 4);
            std::memcpy(&brate, body + 8, 4);
            std::memcpy(&blk, body + 12, 2);
            std::memcpy(&bb, body + 14, 2);
            fmt_tag = tag; channels = ch; bits = bb; sr = (int)rate;
        } else if (!std::memcmp(raw.data() + pos, "data", 4)) {
            data = body;
            data_len = csize;
        }
        pos += 8 + csize + (csize & 1);
    }
    if (!data || channels <= 0 || bits <= 0) return -4;

    int bytes = bits / 8;
    long long frames = data_len / (bytes * channels);
    if (sample_rate) *sample_rate = sr;
    if (!out) return frames;
    if (out_capacity < frames) return -5;

    for (long long i = 0; i < frames; ++i) {
        double acc = 0.0;
        for (int c = 0; c < channels; ++c) {
            const uint8_t* p = data + (i * channels + c) * bytes;
            double v = 0.0;
            if (fmt_tag == 3 && bits == 32) {
                float fv;
                std::memcpy(&fv, p, 4);
                v = fv;
            } else if (fmt_tag == 1 && bits == 16) {
                int16_t s;
                std::memcpy(&s, p, 2);
                v = s / 32768.0;
            } else if (fmt_tag == 1 && bits == 24) {
                int32_t s = (int32_t)(p[0] | (p[1] << 8) | (p[2] << 16));
                if (s >= (1 << 23)) s -= (1 << 24);
                v = s / 8388608.0;
            } else if (fmt_tag == 1 && bits == 32) {
                int32_t s;
                std::memcpy(&s, p, 4);
                v = s / 2147483648.0;
            } else {
                return -6;
            }
            acc += v;
        }
        out[i] = acc / channels;
    }
    return frames;
}

// Encode mono float64 [-1,1] to a PCM WAV (16 or 24 bit). Returns 0 on ok.
int wurli_encode_wav(const char* path, const double* x, long long n,
                     int sample_rate, int bits) {
    if (bits != 16 && bits != 24) return -1;
    FILE* f = std::fopen(path, "wb");
    if (!f) return -2;
    int block = bits / 8;
    uint32_t data_len = (uint32_t)(n * block);
    uint8_t hdr[44];
    std::memcpy(hdr, "RIFF", 4);
    uint32_t riff = 36 + data_len;
    std::memcpy(hdr + 4, &riff, 4);
    std::memcpy(hdr + 8, "WAVEfmt ", 8);
    uint32_t fmt_len = 16;
    std::memcpy(hdr + 16, &fmt_len, 4);
    uint16_t tag = 1, ch = 1, bb = (uint16_t)bits, blk = (uint16_t)block;
    uint32_t rate = (uint32_t)sample_rate, brate = rate * block;
    std::memcpy(hdr + 20, &tag, 2);
    std::memcpy(hdr + 22, &ch, 2);
    std::memcpy(hdr + 24, &rate, 4);
    std::memcpy(hdr + 28, &brate, 4);
    std::memcpy(hdr + 32, &blk, 2);
    std::memcpy(hdr + 34, &bb, 2);
    std::memcpy(hdr + 36, "data", 4);
    std::memcpy(hdr + 40, &data_len, 4);
    std::fwrite(hdr, 1, 44, f);
    for (long long i = 0; i < n; ++i) {
        double v = x[i];
        if (v > 1.0) v = 1.0;
        if (v < -1.0) v = -1.0;
        if (bits == 16) {
            int16_t s = (int16_t)std::lrint(v * 32767.0);
            std::fwrite(&s, 2, 1, f);
        } else {
            int32_t s = (int32_t)std::lrint(v * 8388607.0);
            uint8_t b[3] = {(uint8_t)(s & 0xFF), (uint8_t)((s >> 8) & 0xFF),
                            (uint8_t)((s >> 16) & 0xFF)};
            std::fwrite(b, 3, 1, f);
        }
    }
    std::fclose(f);
    return 0;
}

// Framed RMS + peak envelopes: n_frames = 1 + (n - frame) / hop.
long long wurli_frame_stats(const double* x, long long n, long long frame,
                            long long hop, double* rms_out,
                            double* peak_out) {
    if (frame <= 0 || hop <= 0 || n < frame) return 0;
    long long n_frames = 1 + (n - frame) / hop;
    for (long long k = 0; k < n_frames; ++k) {
        const double* w = x + k * hop;
        double ss = 0.0, pk = 0.0;
        for (long long i = 0; i < frame; ++i) {
            double v = w[i];
            ss += v * v;
            double a = std::fabs(v);
            if (a > pk) pk = a;
        }
        if (rms_out) rms_out[k] = std::sqrt(ss / (double)frame);
        if (peak_out) peak_out[k] = pk;
    }
    return n_frames;
}

}  // extern "C"
