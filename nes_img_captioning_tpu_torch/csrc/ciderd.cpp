// CIDEr-D / CIDEr scorer over integer token sequences (a copy of the JAX
// package's native/ciderd.cpp, built separately for this package).
//
// The host scorer of the port: validation on the host
// (tasks/captioning.py CocoTask.validate) and the train-split CIDEr-D
// scorer (CocoTask.train_scorer) score through it. Semantics are identical
// to the Python implementation in fitness/ciderd.py, which doubles as its
// test oracle (tests/test_torch_scorer.py).
//
// N-grams are packed into uint64 (4 tokens x 16 bits, each token stored +1 so
// the EOS token 0 -- which participates in n-grams, see ciderd.py docstring --
// is distinguishable from an empty slot).
//
// Build: fitness/scorer.py compiles it on first use with
// g++ -O3 -shared -fPIC into nes_img_captioning_tpu_torch/_build/.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <unordered_map>
#include <vector>

namespace {

constexpr int MAX_N = 4;

inline uint64_t pack(const int32_t* toks, int start, int n) {
    uint64_t h = 0;
    for (int i = 0; i < n; ++i) {
        h = (h << 16) | (uint64_t)(uint16_t)(toks[start + i] + 1);
    }
    return h;
}

// tokens up to and including the first 0 (array_to_str semantics)
inline int cut_len(const int32_t* row, int T) {
    for (int i = 0; i < T; ++i) {
        if (row[i] == 0) return i + 1;
    }
    return T;
}

struct OrderTable {
    // union of the image's reference n-grams for one order, sorted by hash;
    // weights is (n_unique x n_refs) row-major: tf*idf of each ref for that
    // n-gram (0 when the ref lacks it). One binary search per candidate
    // n-gram then serves all refs at once.
    std::vector<uint64_t> hashes;
    std::vector<float> weights;
};

struct Image {
    OrderTable tables[MAX_N];
    std::vector<float> norms;    // (n_refs x MAX_N) row-major
    std::vector<int> lengths;    // per ref
    int n_refs = 0;
};

// open-addressing uint64 -> float map: DF lookups are the scoring hot spot
// (one per candidate n-gram) and a flat linear-probe table beats
// unordered_map's pointer chasing ~3x. Key 0 marks empty slots — pack()
// stores tokens +1, so a real n-gram hash is never 0.
struct FlatMap {
    std::vector<uint64_t> keys;
    std::vector<float> vals;
    uint64_t mask = 0;

    static inline uint64_t mix(uint64_t h) {
        h ^= h >> 33;
        h *= 0xff51afd7ed558ccdULL;
        h ^= h >> 33;
        return h;
    }
    void build(const std::unordered_map<uint64_t, float>& src) {
        size_t cap = 16;
        while (cap < src.size() * 2) cap <<= 1;
        keys.assign(cap, 0);
        vals.assign(cap, 0.0f);
        mask = cap - 1;
        for (auto& kv : src) {
            uint64_t i = mix(kv.first) & mask;
            while (keys[i]) i = (i + 1) & mask;
            keys[i] = kv.first;
            vals[i] = kv.second;
        }
    }
    inline float find(uint64_t k) const {
        uint64_t i = mix(k) & mask;
        while (keys[i]) {
            if (keys[i] == k) return vals[i];
            i = (i + 1) & mask;
        }
        return 0.0f;
    }
};

struct Scorer {
    int n;          // max ngram order
    double sigma;   // length-penalty sigma
    bool clip;      // CIDEr-D: clip counts + length penalty
    double ref_len; // log(#images)
    bool df_frozen = false;  // external table installed via cider_set_df
    FlatMap df[MAX_N];
    std::vector<Image> images;

    double idf(int n_i, uint64_t h) const {
        double d = df[n_i].find(h);
        return ref_len - std::log(d < 1.0 ? 1.0 : d);
    }
};

// tf counts of one caption, per order: small sorted vectors
struct CandCounts {
    std::vector<std::pair<uint64_t, float>> tf[MAX_N];
    int length;
};

void count_ngrams(const int32_t* row, int T, int n_max, CandCounts* out) {
    int L = cut_len(row, T);
    out->length = L;
    for (int n = 1; n <= n_max; ++n) {
        auto& v = out->tf[n - 1];
        v.clear();
        for (int i = 0; i + n <= L; ++i) {
            uint64_t h = pack(row, i, n);
            bool found = false;
            for (auto& p : v) {
                if (p.first == h) { p.second += 1.0f; found = true; break; }
            }
            if (!found) v.emplace_back(h, 1.0f);
        }
    }
}

}  // namespace

extern "C" {

void* cider_new(int n, double sigma, int clip) {
    auto* s = new Scorer();
    s->n = n > MAX_N ? MAX_N : n;
    s->sigma = sigma;
    s->clip = clip != 0;
    s->ref_len = 0.0;
    return s;
}

void cider_free(void* h) { delete static_cast<Scorer*>(h); }

// Install a FROZEN document-frequency table (the reference's pickled
// coco-train-idxs blob, loaded host-side): keys are pack()-format uint64
// n-grams, orders their n, ref_len the table's own log(N) constant. Must be
// called BEFORE cider_fit — the fit then skips its DF pass and builds the
// per-image reference vectors against this table, so absolute scores match
// the reference's training fitness (src/captioning/policies.py:72).
void cider_set_df(void* hp, const uint64_t* keys, const float* vals,
                  const int32_t* orders, int64_t n_keys, double ref_len) {
    auto* s = static_cast<Scorer*>(hp);
    std::unordered_map<uint64_t, float> acc[MAX_N];
    for (int64_t i = 0; i < n_keys; ++i) {
        int o = orders[i];
        if (o >= 1 && o <= s->n) acc[o - 1][keys[i]] = vals[i];
    }
    for (int i = 0; i < s->n; ++i) s->df[i].build(acc[i]);
    s->ref_len = ref_len;
    s->df_frozen = true;
}

// refs: (n_rows, T) int32; img_ptr: (n_images+1) row ranges per image.
// Builds the DF table and per-reference tf-idf vectors.
void cider_fit(void* hp, const int32_t* refs, int64_t n_rows, int T,
               const int64_t* img_ptr, int64_t n_images) {
    auto* s = static_cast<Scorer*>(hp);
    s->images.assign(n_images, Image());

    // pass 1: document frequencies (count images, not captions) — skipped
    // when a frozen table was installed via cider_set_df
    if (!s->df_frozen) {
        s->ref_len = std::log((double)(n_images < 1 ? 1 : n_images));
        std::unordered_map<uint64_t, float> df_acc[MAX_N];
        std::unordered_map<uint64_t, int> seen[MAX_N];
        for (int64_t im = 0; im < n_images; ++im) {
            for (int i = 0; i < s->n; ++i) seen[i].clear();
            for (int64_t r = img_ptr[im]; r < img_ptr[im + 1]; ++r) {
                const int32_t* row = refs + r * T;
                int L = cut_len(row, T);
                for (int n = 1; n <= s->n; ++n)
                    for (int i = 0; i + n <= L; ++i)
                        seen[n - 1][pack(row, i, n)] = 1;
            }
            for (int i = 0; i < s->n; ++i)
                for (auto& kv : seen[i]) df_acc[i][kv.first] += 1.0f;
        }
        for (int i = 0; i < s->n; ++i) s->df[i].build(df_acc[i]);
    }

    // pass 2: per-image sorted union tables with per-ref tf-idf columns
    CandCounts cc;
    for (int64_t im = 0; im < n_images; ++im) {
        auto& img = s->images[im];
        int M = (int)(img_ptr[im + 1] - img_ptr[im]);
        img.n_refs = M;
        img.norms.assign((size_t)M * MAX_N, 0.0f);
        img.lengths.assign(M, 0);

        // collect (hash, ref, weight) triples per order
        std::vector<std::pair<uint64_t, std::pair<int, float>>> trip[MAX_N];
        for (int r = 0; r < M; ++r) {
            count_ngrams(refs + (img_ptr[im] + r) * T, T, s->n, &cc);
            img.lengths[r] = cc.length;
            for (int n_i = 0; n_i < s->n; ++n_i) {
                double norm2 = 0.0;
                for (auto& p : cc.tf[n_i]) {
                    float w = (float)(p.second * s->idf(n_i, p.first));
                    trip[n_i].push_back({p.first, {r, w}});
                    norm2 += (double)w * w;
                }
                img.norms[(size_t)r * MAX_N + n_i] = (float)std::sqrt(norm2);
            }
        }
        for (int n_i = 0; n_i < s->n; ++n_i) {
            auto& t = trip[n_i];
            std::sort(t.begin(), t.end(),
                      [](const auto& a, const auto& b) { return a.first < b.first; });
            auto& tab = img.tables[n_i];
            for (size_t k = 0; k < t.size(); ++k) {
                if (tab.hashes.empty() || tab.hashes.back() != t[k].first) {
                    tab.hashes.push_back(t[k].first);
                    tab.weights.resize(tab.hashes.size() * M, 0.0f);
                }
                tab.weights[(tab.hashes.size() - 1) * M + t[k].second.first] =
                    t[k].second.second;
            }
        }
    }
}

// cands: (R, T) int32; img_ids: (R,) indices into the fitted images.
// out: (R,) per-candidate scores.
void cider_score(void* hp, const int32_t* cands, int64_t R, int T,
                 const int64_t* img_ids, double* out) {
    auto* s = static_cast<Scorer*>(hp);
    CandCounts cc;
    std::vector<double> dots;  // (n_refs x n_orders) accumulators
    for (int64_t c = 0; c < R; ++c) {
        count_ngrams(cands + c * T, T, s->n, &cc);
        const Image& img = s->images[img_ids[c]];
        int M = img.n_refs;
        dots.assign((size_t)M * s->n, 0.0);

        double norm_c[MAX_N];
        for (int n_i = 0; n_i < s->n; ++n_i) {
            const auto& tab = img.tables[n_i];
            double norm2 = 0.0;
            for (auto& p : cc.tf[n_i]) {
                float w = (float)(p.second * s->idf(n_i, p.first));
                norm2 += (double)w * w;
                // one binary search serves all refs of the image
                auto it = std::lower_bound(tab.hashes.begin(), tab.hashes.end(),
                                           p.first);
                if (it != tab.hashes.end() && *it == p.first) {
                    const float* row =
                        &tab.weights[(size_t)(it - tab.hashes.begin()) * M];
                    for (int r = 0; r < M; ++r) {
                        float wr = row[r];
                        float wcl = s->clip ? (w < wr ? w : wr) : w;
                        dots[(size_t)r * s->n + n_i] += (double)wcl * wr;
                    }
                }
            }
            norm_c[n_i] = std::sqrt(norm2);
        }

        double acc = 0.0;
        for (int r = 0; r < M; ++r) {
            double val = 0.0;
            for (int n_i = 0; n_i < s->n; ++n_i) {
                double dot = dots[(size_t)r * s->n + n_i];
                float nr = img.norms[(size_t)r * MAX_N + n_i];
                if (norm_c[n_i] != 0.0 && nr != 0.0f)
                    dot /= norm_c[n_i] * (double)nr;
                val += dot;
            }
            if (s->clip) {
                double delta = (double)(cc.length - img.lengths[r]);
                val *= std::exp(-(delta * delta) / (2.0 * s->sigma * s->sigma));
            }
            acc += val;
        }
        out[c] = 10.0 * acc / (double)(M * s->n);
    }
}

}  // extern "C"
