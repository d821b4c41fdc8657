// Host sketch kernels: Murmur3_x86_32, BloomFilter, CountMinSketch.
//
// The port of spark_tpu/native/src/sketch.cpp's sketch half, the native
// counterpart of the reference's `common/sketch` package
// (`util/sketch/BloomFilterImpl.java`, `CountMinSketchImpl.java`) and
// its `Murmur3_x86_32.java` hash.  Bit-exact with the numpy plain versions
// in `sketch.py`.  Sums that may wrap (h1 + i * h2) are computed in
// uint32_t, where wrapping is defined, then read as int32_t.
//
// A C ABI bound with ctypes; built by `build.py` (g++ -O3 -shared -fPIC).

#include <cstdint>

extern "C" {

static inline uint32_t rotl32(uint32_t x, int8_t r) {
    return (x << r) | (x >> (32 - r));
}

static inline uint32_t fmix32(uint32_t h) {
    h ^= h >> 16; h *= 0x85ebca6bu;
    h ^= h >> 13; h *= 0xc2b2ae35u;
    h ^= h >> 16;
    return h;
}

static inline uint32_t mixK1(uint32_t k1) {
    k1 *= 0xcc9e2d51u; k1 = rotl32(k1, 15); k1 *= 0x1b873593u;
    return k1;
}

static inline uint32_t mixH1(uint32_t h1, uint32_t k1) {
    h1 ^= k1; h1 = rotl32(h1, 13); h1 = h1 * 5u + 0xe6546b64u;
    return h1;
}

// hashLong: two 32-bit halves, low first (Murmur3_x86_32.java)
static inline int32_t hash_long(int64_t input, int32_t seed) {
    uint64_t x = (uint64_t)input;
    uint32_t h1 = (uint32_t)seed;
    h1 = mixH1(h1, mixK1((uint32_t)x));
    h1 = mixH1(h1, mixK1((uint32_t)(x >> 32)));
    return (int32_t)fmix32(h1 ^ 8u);
}

// out[j] = hashLong(items[j], seeds ? seeds[j] : seed)
void murmur3_hash_longs(const int64_t* items, const int32_t* seeds,
                        int32_t seed, int64_t n, int32_t* out) {
    for (int64_t j = 0; j < n; j++)
        out[j] = hash_long(items[j], seeds ? seeds[j] : seed);
}

// BloomFilterImpl.putLong / mightContainLong: h1 = hash(seed 0),
// h2 = hash(seed h1), probes h1 + i * h2 for i in 1..k, negatives
// complemented
static inline int64_t probe(int32_t h1, int32_t h2, int32_t i,
                            int64_t num_bits) {
    int32_t combined = (int32_t)((uint32_t)h1 + (uint32_t)i * (uint32_t)h2);
    if (combined < 0) combined = ~combined;
    return combined % num_bits;
}

void bloom_put_longs(uint64_t* bits, int64_t num_bits, int32_t num_hashes,
                     const int64_t* items, int64_t n) {
    for (int64_t j = 0; j < n; j++) {
        int32_t h1 = hash_long(items[j], 0);
        int32_t h2 = hash_long(items[j], h1);
        for (int32_t i = 1; i <= num_hashes; i++) {
            int64_t bit = probe(h1, h2, i, num_bits);
            bits[bit >> 6] |= (1ull << (bit & 63));
        }
    }
}

void bloom_might_contain_longs(const uint64_t* bits, int64_t num_bits,
                               int32_t num_hashes, const int64_t* items,
                               int64_t n, uint8_t* out) {
    for (int64_t j = 0; j < n; j++) {
        int32_t h1 = hash_long(items[j], 0);
        int32_t h2 = hash_long(items[j], h1);
        uint8_t hit = 1;
        for (int32_t i = 1; i <= num_hashes && hit; i++) {
            int64_t bit = probe(h1, h2, i, num_bits);
            if (!(bits[bit >> 6] & (1ull << (bit & 63)))) hit = 0;
        }
        out[j] = hit;
    }
}

// CountMinSketchImpl.addLong / estimateCount: row i uses
// hash(item, seed i), complemented when negative, modulo the width
void cms_add_longs(int64_t* table, int32_t depth, int32_t width,
                   const int64_t* items, int64_t n, int64_t count) {
    for (int64_t j = 0; j < n; j++) {
        for (int32_t i = 0; i < depth; i++) {
            int32_t h = hash_long(items[j], i);
            if (h < 0) h = ~h;
            table[(int64_t)i * width + (h % width)] += count;
        }
    }
}

void cms_estimate_longs(const int64_t* table, int32_t depth, int32_t width,
                        const int64_t* items, int64_t n, int64_t* out) {
    for (int64_t j = 0; j < n; j++) {
        int64_t best = INT64_MAX;
        for (int32_t i = 0; i < depth; i++) {
            int32_t h = hash_long(items[j], i);
            if (h < 0) h = ~h;
            int64_t v = table[(int64_t)i * width + (h % width)];
            if (v < best) best = v;
        }
        out[j] = best;
    }
}

}  // extern "C"
