// Native CIDEr-D scorer: the CST reward hot path (in-loop consensus
// scoring must stay far cheaper than the device step).  Drop-in twin of
// the Python scorer in cst_captioning_torch/metrics/cider.py +
// training/rewards.py: identical math (tf-idf over n=1..4 id n-grams,
// count-clipped cosine, Gaussian length penalty, x10 scale), corpus-mode
// document frequencies.  The port's copy of the JAX package's
// native/ciderd.cpp, unchanged below this header.
//
// Design notes:
// * Token ids are < 2^15 (vocab ~10-20k; the Python wrapper enforces the
//   bound and falls back otherwise), so an n-gram (n<=4) packs exactly
//   into a uint64 key: 15 bits per token (60) + 2 bits n-gram order —
//   exact, no hash collisions.  Word ids start at 4 (0=PAD, 1=BOS,
//   2=EOS, 3=UNK), so a zero slot is unambiguous.
// * Per-video reference vectors are cooked once at finalize(); scoring a
//   candidate is one pass to count its n-grams plus one hash lookup per
//   (candidate n-gram, reference).
// * Plain C ABI, bound with ctypes (native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kNGrams = 4;
constexpr double kSigma = 6.0;
constexpr int kPad = 0, kBos = 1, kEos = 2;

using Counts = std::unordered_map<uint64_t, float>;

struct RefVec {
  // tf-idf weights per n-gram order, L2 norm per order, unigram length.
  Counts vec[kNGrams];
  double norm[kNGrams];
  long length;
};

struct Video {
  std::vector<std::vector<int>> refs;   // token ids per reference
  std::vector<RefVec> ref_vecs;         // cooked at finalize()
  std::vector<float> weights;           // per-ref consensus weights
                                        // (empty = uniform)
  // Merged scoring structure: one hash lookup per CANDIDATE n-gram
  // instead of one per (n-gram, reference).  merged[key][r] = ref r's
  // tf-idf weight for that n-gram (0 when absent); norms/lengths are the
  // per-ref per-order L2 norms and unigram lengths.
  std::unordered_map<uint64_t, std::vector<float>> merged;
  std::vector<double> ref_norms;        // nref * kNGrams
  std::vector<long> ref_lengths;        // nref
};

struct Scorer {
  std::vector<Video> videos;
  std::unordered_map<uint64_t, float> doc_freq;  // over videos (corpus mode)
  double log_ref_len = 0.0;
  bool finalized = false;
};

inline uint64_t pack(const int* toks, int n) {
  uint64_t key = 0;
  for (int i = 0; i < n; ++i) {
    key = (key << 15) | static_cast<uint64_t>(toks[i] & 0x7fff);
  }
  // Disambiguate orders so ("a") and ("\0","a") can't collide: bits
  // 60-61 hold (n-1).
  return key | (static_cast<uint64_t>(n - 1) << 60);
}

void precook(const std::vector<int>& toks, Counts out[kNGrams]) {
  const int len = static_cast<int>(toks.size());
  for (int n = 1; n <= kNGrams; ++n) {
    for (int i = 0; i + n <= len; ++i) {
      out[n - 1][pack(toks.data() + i, n)] += 1.0f;
    }
  }
}

void counts_to_vec(const Counts cnts[kNGrams],
                   const std::unordered_map<uint64_t, float>& df,
                   double log_ref_len, RefVec* rv) {
  rv->length = 0;
  for (int n = 0; n < kNGrams; ++n) {
    rv->norm[n] = 0.0;
    rv->vec[n].clear();
    for (const auto& kv : cnts[n]) {
      auto it = df.find(kv.first);
      double d = it == df.end() ? 0.0 : it->second;
      double idf = log_ref_len - std::log(std::max(1.0, d));
      double w = static_cast<double>(kv.second) * idf;
      rv->vec[n][kv.first] = static_cast<float>(w);
      rv->norm[n] += w * w;
      if (n == 0) rv->length += static_cast<long>(kv.second);
    }
    rv->norm[n] = std::sqrt(rv->norm[n]);
  }
}

// Build the merged per-video scoring structure from cooked ref_vecs and
// release the per-ref maps (scoring never touches them again).
void build_merged(Video* v) {
  const size_t nref = v->ref_vecs.size();
  v->merged.clear();
  v->ref_norms.assign(nref * kNGrams, 0.0);
  v->ref_lengths.assign(nref, 0);
  for (size_t r = 0; r < nref; ++r) {
    const RefVec& rv = v->ref_vecs[r];
    v->ref_lengths[r] = rv.length;
    for (int n = 0; n < kNGrams; ++n) {
      v->ref_norms[r * kNGrams + n] = rv.norm[n];
      for (const auto& kv : rv.vec[n]) {
        auto& slot = v->merged[kv.first];
        if (slot.empty()) slot.assign(nref, 0.0f);
        slot[r] = kv.second;
      }
    }
  }
  v->ref_vecs.clear();
  v->ref_vecs.shrink_to_fit();
}

// CIDEr-D of one cooked hypothesis against every reference of `v` at
// once: one merged-map lookup per hypothesis n-gram, then per-ref
// normalization + Gaussian length penalty.  out_sims[r] = sim_d(hyp, r).
void sim_d_all(const RefVec& hyp, const Video& v, double* out_sims) {
  const size_t nref = v.ref_lengths.size();
  std::vector<double> acc(nref * kNGrams, 0.0);
  for (int n = 0; n < kNGrams; ++n) {
    for (const auto& kv : hyp.vec[n]) {
      auto it = v.merged.find(kv.first);
      if (it == v.merged.end()) continue;
      const float* m = it->second.data();
      const float wh = kv.second;
      double* a = acc.data() + n;  // stride kNGrams per ref
      for (size_t r = 0; r < nref; ++r) {
        a[r * kNGrams] += static_cast<double>(std::min(wh, m[r])) *
                          static_cast<double>(m[r]);
      }
    }
  }
  for (size_t r = 0; r < nref; ++r) {
    const double delta = static_cast<double>(hyp.length - v.ref_lengths[r]);
    const double penalty =
        std::exp(-(delta * delta) / (2.0 * kSigma * kSigma));
    double total = 0.0;
    for (int n = 0; n < kNGrams; ++n) {
      double val = acc[r * kNGrams + n];
      const double nr = v.ref_norms[r * kNGrams + n];
      if (hyp.norm[n] != 0.0 && nr != 0.0) val /= hyp.norm[n] * nr;
      total += val * penalty;
    }
    out_sims[r] = total;
  }
}

}  // namespace

extern "C" {

void* ciderd_new() { return new Scorer(); }

void ciderd_free(void* h) { delete static_cast<Scorer*>(h); }

// Add one video's references: `tokens` is the concatenation of all refs'
// ids, `ref_lens[i]` the length of ref i.  Call in dataset index order.
void ciderd_add_video(void* h, const int* tokens, const int* ref_lens,
                      int num_refs) {
  auto* s = static_cast<Scorer*>(h);
  Video v;
  int off = 0;
  for (int r = 0; r < num_refs; ++r) {
    v.refs.emplace_back(tokens + off, tokens + off + ref_lens[r]);
    off += ref_lens[r];
  }
  s->videos.push_back(std::move(v));
}

// Optional per-reference consensus weights for the most recently added
// video (the paper's weighted-consensus reward).  Normalized at score
// time; call after ciderd_add_video.
void ciderd_set_video_weights(void* h, int video, const float* w, int n) {
  auto* s = static_cast<Scorer*>(h);
  if (video < 0 || video >= static_cast<int>(s->videos.size())) return;
  s->videos[video].weights.assign(w, w + n);
}

// Corpus-mode finalize: df[ngram] = number of videos whose ref set
// contains it; log_ref_len = log(max(#videos, 2)); cook every ref.
void ciderd_finalize(void* h) {
  auto* s = static_cast<Scorer*>(h);
  s->doc_freq.clear();
  for (auto& v : s->videos) {
    std::unordered_map<uint64_t, char> seen;
    for (auto& ref : v.refs) {
      Counts cnts[kNGrams];
      precook(ref, cnts);
      for (int n = 0; n < kNGrams; ++n)
        for (const auto& kv : cnts[n]) seen.emplace(kv.first, 1);
    }
    for (const auto& kv : seen) s->doc_freq[kv.first] += 1.0f;
  }
  s->log_ref_len =
      std::log(std::max(static_cast<double>(s->videos.size()), 2.0));
  for (auto& v : s->videos) {
    v.ref_vecs.clear();
    for (auto& ref : v.refs) {
      Counts cnts[kNGrams];
      precook(ref, cnts);
      RefVec rv;
      counts_to_vec(cnts, s->doc_freq, s->log_ref_len, &rv);
      v.ref_vecs.push_back(std::move(rv));
    }
    build_merged(&v);
  }
  s->finalized = true;
}

// Externally-supplied document frequencies (idf-table mode).  Entries:
// flat_ngrams = concatenated ids, ngram_lens[i] in [1,4], dfs[i] raw df.
// Must be followed by ciderd_finalize_with_df(log_ref_len).
void ciderd_set_df(void* h, const int* flat_ngrams, const int* ngram_lens,
                   const float* dfs, int count) {
  auto* s = static_cast<Scorer*>(h);
  s->doc_freq.clear();
  int off = 0;
  for (int i = 0; i < count; ++i) {
    uint64_t key = pack(flat_ngrams + off, ngram_lens[i]);
    auto it = s->doc_freq.find(key);
    // UNK-collapse collisions keep the max df (conservative idf) —
    // matches rewards.py's re-keying rule.
    if (it == s->doc_freq.end() || it->second < dfs[i]) s->doc_freq[key] = dfs[i];
    off += ngram_lens[i];
  }
}

void ciderd_finalize_with_df(void* h, double log_ref_len) {
  auto* s = static_cast<Scorer*>(h);
  s->log_ref_len = log_ref_len;
  for (auto& v : s->videos) {
    v.ref_vecs.clear();
    for (auto& ref : v.refs) {
      Counts cnts[kNGrams];
      precook(ref, cnts);
      RefVec rv;
      counts_to_vec(cnts, s->doc_freq, s->log_ref_len, &rv);
      v.ref_vecs.push_back(std::move(rv));
    }
    build_merged(&v);
  }
  s->finalized = true;
}

int ciderd_num_videos(void* h) {
  return static_cast<int>(static_cast<Scorer*>(h)->videos.size());
}

// Score a batch: tokens (batch x max_len) int32 rows — candidate stops at
// the first PAD/EOS, BOS skipped; video_idx (batch,) dataset indices.
// out (batch,) float32 CIDEr-D x10.
// Returns 0 on success, -1 if any video_idx is out of range (the Python
// wrapper raises IndexError — matching the Python scorer — instead of UB).
namespace {

void score_rows(const Scorer* s, const int* video_idx, const int* tokens,
                int max_len, float* out, int begin, int end) {
  for (int b = begin; b < end; ++b) {
    const int* row = tokens + static_cast<long>(b) * max_len;
    std::vector<int> cand;
    cand.reserve(max_len);
    for (int i = 0; i < max_len; ++i) {
      int t = row[i];
      if (t == kPad || t == kEos) break;
      if (t == kBos) continue;
      cand.push_back(t);
    }
    Counts cnts[kNGrams];
    precook(cand, cnts);
    RefVec hyp;
    counts_to_vec(cnts, s->doc_freq, s->log_ref_len, &hyp);
    const Video& v = s->videos[video_idx[b]];
    const size_t nref = v.ref_lengths.size();
    if (nref == 0) {  // reference-less video: reward 0, not NaN
      out[b] = 0.0f;
      continue;
    }
    std::vector<double> sims(nref);
    sim_d_all(hyp, v, sims.data());
    double total = 0.0;
    if (v.weights.size() == nref) {
      double wsum = 0.0;
      for (float w : v.weights) wsum += w;
      const bool degenerate = wsum <= 1e-12;
      for (size_t r = 0; r < nref; ++r) {
        const double w =
            degenerate ? 1.0 / nref : v.weights[r] / wsum;
        total += w * sims[r];
      }
      out[b] = static_cast<float>(total / kNGrams * 10.0);
    } else {
      for (size_t r = 0; r < nref; ++r) total += sims[r];
      out[b] = static_cast<float>(
          total / kNGrams / static_cast<double>(nref) * 10.0);
    }
  }
}

}  // namespace

namespace {

// Leave-one-out consensus of one video: ref j scored (as a hypothesis)
// against its siblings, mean over j.  Twin of
// rewards.CiderDRewarder.gt_consensus()'s per-video body — same df
// table, same optional per-ref weights renormalized over the siblings.
void gt_consensus_rows(const Scorer* s, float* out, int begin, int end) {
  for (int i = begin; i < end; ++i) {
    const Video& v = s->videos[i];
    const size_t nref = v.ref_lengths.size();
    if (nref < 2) {  // matches the Python early-continue (score 0)
      out[i] = 0.0f;
      continue;
    }
    const bool weighted = v.weights.size() == nref;
    double mean = 0.0;
    std::vector<double> sims(nref);
    for (size_t j = 0; j < nref; ++j) {
      Counts cnts[kNGrams];
      precook(v.refs[j], cnts);
      RefVec hyp;
      counts_to_vec(cnts, s->doc_freq, s->log_ref_len, &hyp);
      sim_d_all(hyp, v, sims.data());
      double total = 0.0;
      if (weighted) {
        double wsum = 0.0;
        for (size_t r = 0; r < nref; ++r) {
          if (r != j) wsum += v.weights[r];
        }
        const bool degenerate = wsum <= 1e-12;
        for (size_t r = 0; r < nref; ++r) {
          if (r == j) continue;
          const double w = degenerate
                               ? 1.0 / static_cast<double>(nref - 1)
                               : v.weights[r] / wsum;
          total += w * sims[r];
        }
        mean += total / kNGrams * 10.0;
      } else {
        for (size_t r = 0; r < nref; ++r) {
          if (r != j) total += sims[r];
        }
        mean += total / kNGrams / static_cast<double>(nref - 1) * 10.0;
      }
    }
    out[i] = static_cast<float>(mean / static_cast<double>(nref));
  }
}

}  // namespace

// Leave-one-out GT consensus for every video -> out (num_videos,)
// float32, CIDEr-D x10 units (same scale as ciderd_score rewards).  One
// call at CST startup for cst_baseline='gt_consensus'; threaded — at
// MSR-VTT scale this is ~200k scorings (ADVICE r4 #3).
void ciderd_gt_consensus(void* h, float* out) {
  auto* s = static_cast<Scorer*>(h);
  const int n = static_cast<int>(s->videos.size());
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int workers = std::max(1, std::min({hw, n / 16, 16}));
  if (workers <= 1) {
    gt_consensus_rows(s, out, 0, n);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(workers);
  const int chunk = (n + workers - 1) / workers;
  for (int w = 0; w < workers; ++w) {
    const int begin = w * chunk;
    const int end = std::min(n, begin + chunk);
    if (begin >= end) break;
    pool.emplace_back(gt_consensus_rows, s, out, begin, end);
  }
  for (auto& t : pool) t.join();
}

int ciderd_score(void* h, const int* video_idx, const int* tokens, int batch,
                 int max_len, float* out) {
  auto* s = static_cast<Scorer*>(h);
  const int n = static_cast<int>(s->videos.size());
  for (int b = 0; b < batch; ++b) {
    if (video_idx[b] < 0 || video_idx[b] >= n) return -1;
  }
  // Rows are independent over a read-only scorer — fan out across cores.
  // A CST step scores B*S (e.g. 1280) rollouts; single-threaded this is
  // the dominant host cost (SURVEY.md hard part #1).  Threads are
  // spawned per call (~0.3 ms for 16) — noise against the >=64-rows-per-
  // worker scoring time that gates spawning; small batches stay inline.
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int workers = std::max(1, std::min({hw, batch / 64, 16}));
  if (workers <= 1) {
    score_rows(s, video_idx, tokens, max_len, out, 0, batch);
    return 0;
  }
  std::vector<std::thread> pool;
  pool.reserve(workers);
  const int chunk = (batch + workers - 1) / workers;
  for (int w = 0; w < workers; ++w) {
    const int begin = w * chunk;
    const int end = std::min(batch, begin + chunk);
    if (begin >= end) break;
    pool.emplace_back(score_rows, s, video_idx, tokens, max_len, out,
                      begin, end);
  }
  for (auto& t : pool) t.join();
  return 0;
}

}  // extern "C"
