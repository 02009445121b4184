// Native serialization codec: coefficient bit-packing, CRC32 and the LZ4
// block format (the port's copy of node_fhe_accelerate_tpu/native/codec.cpp,
// the same functions under the same names).
//
// Ballots and keys with q < 2^64 pack their coefficients to ceil(log2 q)
// bits (a 41-bit modulus stores 1.56x smaller than raw u64, the reference's
// <10KB ballot budget, key_serializer.h:392), and CRC32 runs at memory
// speed.
//
// Exposed via ctypes (node_fhe_accelerate_tpu_torch/native/__init__.py),
// which builds it with g++ into build/native/, with a pure-Python fallback
// when no compiler is available.

#include <cstdint>
#include <cstddef>
#include <cstring>

extern "C" {

// CRC-32 (IEEE, zlib-compatible), slice-by-one with a lazily built table.
static uint32_t crc_table[256];
static bool crc_ready = false;

static void build_table() {
    for (uint32_t i = 0; i < 256; ++i) {
        uint32_t c = i;
        for (int k = 0; k < 8; ++k)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc_table[i] = c;
    }
    crc_ready = true;
}

uint32_t nfa_crc32(const uint8_t* data, size_t len, uint32_t seed) {
    if (!crc_ready) build_table();
    uint32_t c = seed ^ 0xFFFFFFFFu;
    for (size_t i = 0; i < len; ++i)
        c = crc_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

// Pack n little-endian u64 words to `bits` bits each (bits in [1, 64]).
// out must hold at least (n*bits + 7)/8 bytes. Returns bytes written.
size_t nfa_pack_words(const uint64_t* in, size_t n, uint32_t bits,
                      uint8_t* out) {
    size_t out_len = (n * bits + 7) / 8;
    std::memset(out, 0, out_len);
    size_t bitpos = 0;
    for (size_t i = 0; i < n; ++i) {
        uint64_t v = (bits == 64) ? in[i]
                                  : (in[i] & ((1ULL << bits) - 1ULL));
        size_t byte = bitpos >> 3;
        unsigned shift = bitpos & 7;
        // write up to 9 bytes
        uint8_t* p = out + byte;
        uint64_t cur = v << shift;
        for (int b = 0; b < 8; ++b)
            p[b] |= (uint8_t)(cur >> (8 * b));
        if (shift + bits > 64)
            p[8] |= (uint8_t)(v >> (64 - shift));
        bitpos += bits;
    }
    return out_len;
}

// Unpack n words of `bits` bits each from the packed stream.
void nfa_unpack_words(const uint8_t* in, size_t n, uint32_t bits,
                      uint64_t* out) {
    size_t bitpos = 0;
    uint64_t mask = (bits == 64) ? ~0ULL : ((1ULL << bits) - 1ULL);
    for (size_t i = 0; i < n; ++i) {
        size_t byte = bitpos >> 3;
        unsigned shift = bitpos & 7;
        uint64_t v = 0;
        const uint8_t* p = in + byte;
        for (int b = 0; b < 8; ++b)
            v |= ((uint64_t)p[b]) << (8 * b);
        v >>= shift;
        if (shift + bits > 64)
            v |= ((uint64_t)p[8]) << (64 - shift);
        out[i] = v & mask;
        bitpos += bits;
    }
}

// ---------------------------------------------------------------------------
// LZ4 block format codec (key_serializer.h:30-112 offers ZLIB or LZ4; this
// is a from-scratch implementation of the public LZ4 block format:
// sequences of [token][literals][2-byte offset][match], greedy hash-chain
// matcher).  Compress returns the compressed size, or 0 when out_cap is
// too small (caller falls back to stored/zlib).

static inline uint32_t lz4_hash(uint32_t v) {
    return (v * 2654435761u) >> 20;   // 12-bit table
}

static inline uint32_t read32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

size_t nfa_lz4_compress(const uint8_t* in, size_t n, uint8_t* out,
                        size_t out_cap) {
    const size_t MINMATCH = 4, LASTLITERALS = 5, MFLIMIT = 12;
    uint32_t table[1 << 12];
    std::memset(table, 0, sizeof(table));
    size_t ip = 0, anchor = 0, op = 0;

    auto emit = [&](size_t lit_len, size_t match_len, size_t offset,
                    const uint8_t* lit) -> bool {
        size_t need = 1 + lit_len + lit_len / 255 + 1 +
                      (match_len ? 2 + match_len / 255 + 1 : 0);
        if (op + need + 8 > out_cap) return false;
        uint8_t* tok = out + op++;
        // literal length
        if (lit_len >= 15) {
            *tok = 15 << 4;
            size_t rest = lit_len - 15;
            while (rest >= 255) { out[op++] = 255; rest -= 255; }
            out[op++] = (uint8_t)rest;
        } else {
            *tok = (uint8_t)(lit_len << 4);
        }
        std::memcpy(out + op, lit, lit_len);
        op += lit_len;
        if (match_len) {
            out[op++] = (uint8_t)(offset & 0xFF);
            out[op++] = (uint8_t)(offset >> 8);
            size_t ml = match_len - MINMATCH;
            if (ml >= 15) {
                *tok |= 15;
                size_t rest = ml - 15;
                while (rest >= 255) { out[op++] = 255; rest -= 255; }
                out[op++] = (uint8_t)rest;
            } else {
                *tok |= (uint8_t)ml;
            }
        }
        return true;
    };

    if (n >= MFLIMIT) {
        const size_t match_limit = n - LASTLITERALS;
        while (ip + MFLIMIT <= n) {
            uint32_t h = lz4_hash(read32(in + ip));
            size_t cand = table[h];
            table[h] = (uint32_t)ip;
            if (ip > cand && ip - cand <= 65535 &&
                read32(in + cand) == read32(in + ip)) {
                size_t ml = MINMATCH;
                while (ip + ml < match_limit && in[cand + ml] == in[ip + ml])
                    ++ml;
                if (!emit(ip - anchor, ml, ip - cand, in + anchor)) return 0;
                ip += ml;
                anchor = ip;
            } else {
                ++ip;
            }
        }
    }
    // trailing literals
    if (!emit(n - anchor, 0, 0, in + anchor)) return 0;
    return op;
}

// Returns 0 on success, -1 on malformed input / size mismatch.
int nfa_lz4_decompress(const uint8_t* in, size_t n, uint8_t* out,
                       size_t out_n) {
    size_t ip = 0, op = 0;
    while (ip < n) {
        uint8_t token = in[ip++];
        size_t lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (ip >= n) return -1;
                b = in[ip++];
                lit += b;
            } while (b == 255);
        }
        if (ip + lit > n || op + lit > out_n) return -1;
        std::memcpy(out + op, in + ip, lit);
        ip += lit;
        op += lit;
        if (ip >= n) break;              // last sequence: literals only
        if (ip + 2 > n) return -1;
        size_t offset = in[ip] | ((size_t)in[ip + 1] << 8);
        ip += 2;
        if (offset == 0 || offset > op) return -1;
        size_t ml = (token & 15);
        if (ml == 15) {
            uint8_t b;
            do {
                if (ip >= n) return -1;
                b = in[ip++];
                ml += b;
            } while (b == 255);
        }
        ml += 4;
        if (op + ml > out_n) return -1;
        // overlapping copy must run forward byte-by-byte
        for (size_t i = 0; i < ml; ++i, ++op)
            out[op] = out[op - offset];
    }
    return op == out_n ? 0 : -1;
}

}  // extern "C"
