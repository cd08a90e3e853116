// Native host-runtime component: paged-KV block allocator with content-hash
// prefix caching + LRU eviction. The port's own copy of the JAX package's
// native/block_allocator.cpp; it mirrors the semantics of
// modules/block_kv_cache.py BlockAllocator exactly (tests assert identical
// block-id sequences).
//
// One addition: a SALT seeds the hash chain. Its first parent is 0 for an
// empty salt (the JAX package's chain, block for block) and a non-zero
// FNV-1a digest of the salt bytes otherwise, so prompts match only under
// the same salt (the port keys its prefix cache by LoRA adapter). The
// prefix-caching switch can also be flipped on a live allocator, as the
// Python allocator's attribute can.
//
// The allocator sits on the per-step host hot path of the paged serving loop
// (begin_sequence/grow/end_sequence per request per token), which is why it
// is native: no Python dict/list overhead, O(1) ops via intrusive free list +
// LRU, 64-bit FNV-1a chained block hashing.
//
// C ABI (ctypes-friendly), no exceptions across the boundary.

#include <cstdint>
#include <cstring>
#include <list>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint64_t kFnvOffset = 1469598103934665603ULL;
constexpr uint64_t kFnvPrime = 1099511628211ULL;

inline uint64_t fnv1a(uint64_t h, const uint8_t* data, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    h ^= data[i];
    h *= kFnvPrime;
  }
  return h;
}

inline uint64_t hash_block(uint64_t parent, const int64_t* tokens, int n) {
  uint64_t h = kFnvOffset;
  h = fnv1a(h, reinterpret_cast<const uint8_t*>(&parent), sizeof(parent));
  h = fnv1a(h, reinterpret_cast<const uint8_t*>(tokens),
            static_cast<size_t>(n) * sizeof(int64_t));
  // avoid the reserved "no hash" sentinel
  return h == 0 ? 1 : h;
}

struct BlockMeta {
  int32_t ref_count = 0;
  uint64_t content_hash = 0;  // 0 = none (mutable / tail block)
};

class Allocator {
 public:
  Allocator(int num_blocks, int block_size, bool prefix_caching)
      : block_size_(block_size),
        prefix_(prefix_caching),
        num_blocks_(num_blocks),
        meta_(num_blocks) {
    free_list_.reserve(num_blocks);
    for (int i = 1; i < num_blocks; ++i) free_list_.push_back(i);
  }

  void set_prefix_caching(bool on) { prefix_ = on; }

  int num_free() const {
    return static_cast<int>(free_list_.size() + lru_.size());
  }

  // returns number of blocks written to out_blocks, or -1 on OOM/overflow
  int allocate(const int64_t* tokens, int n_tokens, int* out_blocks,
               int max_out, int* out_cached_tokens, uint64_t seed) {
    int n_blocks = n_tokens <= 0 ? 1 : (n_tokens + block_size_ - 1) / block_size_;
    if (n_blocks > max_out) return -1;
    int cached = 0;
    uint64_t parent = seed;
    bool matching = prefix_;
    for (int bi = 0; bi < n_blocks; ++bi) {
      const int64_t* chunk = tokens + static_cast<int64_t>(bi) * block_size_;
      int chunk_len = n_tokens - bi * block_size_;
      if (chunk_len > block_size_) chunk_len = block_size_;
      bool full = chunk_len == block_size_;
      if (matching && full) {
        uint64_t h = hash_block(parent, chunk, chunk_len);
        auto it = hash_to_block_.find(h);
        if (it != hash_to_block_.end()) {
          int blk = it->second;
          BlockMeta& m = meta_[blk];
          if (m.ref_count == 0) {
            auto li = lru_pos_.find(blk);
            if (li != lru_pos_.end()) {
              lru_.erase(li->second);
              lru_pos_.erase(li);
            }
          }
          m.ref_count += 1;
          out_blocks[bi] = blk;
          cached += block_size_;
          parent = h;
          continue;
        }
      }
      matching = false;
      int blk = pop_block();
      if (blk < 0) {
        // roll back this call's allocations: prefix-HIT blocks keep their
        // (valid, pre-existing) hashes; fresh blocks were hashed before
        // their content was ever written, so their hashes must be purged
        // or later allocations would "hit" garbage KV
        int n_hit = cached / block_size_;
        for (int j = 0; j < bi; ++j) {
          if (j < n_hit) release_one(out_blocks[j]);
          else invalidate_one(out_blocks[j]);
        }
        return -1;
      }
      BlockMeta& m = meta_[blk];
      m.ref_count += 1;
      if (prefix_ && full) {
        uint64_t h = hash_block(parent, chunk, chunk_len);
        m.content_hash = h;
        hash_to_block_[h] = blk;
        parent = h;
      }
      out_blocks[bi] = blk;
    }
    *out_cached_tokens = cached;
    return n_blocks;
  }

  // READ-ONLY prefix-warmth probe: how many leading tokens allocate()
  // would serve from the prefix cache right now, writing the hit block
  // ids to out_blocks. Takes no references, touches no LRU order — a
  // scheduler calls this per queued request to order admissions.
  int probe(const int64_t* tokens, int n_tokens, int* out_blocks,
            int max_out, uint64_t seed) const {
    if (!prefix_) return 0;
    int cached = 0;
    uint64_t parent = seed;
    int n_full = n_tokens / block_size_;
    for (int bi = 0; bi < n_full && bi < max_out; ++bi) {
      const int64_t* chunk = tokens + static_cast<int64_t>(bi) * block_size_;
      parent = hash_block(parent, chunk, block_size_);
      auto it = hash_to_block_.find(parent);
      if (it == hash_to_block_.end()) break;
      out_blocks[bi] = it->second;
      cached += block_size_;
    }
    return cached;
  }

  // grow blocks to cover new_len tokens; returns new count or -1
  // (rolling back this call's additions on OOM)
  int extend(int* blocks, int n_blocks, int new_len, int max_out) {
    int need = new_len <= 0 ? 1 : (new_len + block_size_ - 1) / block_size_;
    if (need > max_out) return -1;
    int start = n_blocks;
    while (n_blocks < need) {
      int blk = pop_block();
      if (blk < 0) {
        for (int j = start; j < n_blocks; ++j) release_one(blocks[j]);
        return -1;
      }
      meta_[blk].ref_count += 1;
      blocks[n_blocks++] = blk;
    }
    return n_blocks;
  }

  // returns 0 ok, -1 double free
  int free_blocks(const int* blocks, int n) {
    for (int i = 0; i < n; ++i) {
      if (release_one(blocks[i]) < 0) return -1;
    }
    return 0;
  }

  // free blocks whose pending content was never written (aborted
  // admission): once unreferenced they go back to the free list with
  // their hash registration dropped, so the prefix cache can never
  // serve their contents. returns 0 ok, -1 double free
  int invalidate_blocks(const int* blocks, int n) {
    for (int i = 0; i < n; ++i) {
      if (invalidate_one(blocks[i]) < 0) return -1;
    }
    return 0;
  }

 private:
  int release_one(int blk) {
    BlockMeta& m = meta_[blk];
    m.ref_count -= 1;
    if (m.ref_count < 0) return -1;
    if (m.ref_count == 0) {
      if (m.content_hash != 0) {
        lru_.push_back(blk);  // stays resident for prefix reuse
        lru_pos_[blk] = std::prev(lru_.end());
      } else {
        free_list_.push_back(blk);
      }
    }
    return 0;
  }

  int invalidate_one(int blk) {
    BlockMeta& m = meta_[blk];
    m.ref_count -= 1;
    if (m.ref_count < 0) return -1;
    if (m.ref_count == 0) {
      if (m.content_hash != 0) {
        auto it = hash_to_block_.find(m.content_hash);
        if (it != hash_to_block_.end() && it->second == blk)
          hash_to_block_.erase(it);
        m.content_hash = 0;
      }
      free_list_.push_back(blk);
    }
    // ref_count > 0: another sequence still references it, so its
    // content predates the aborted call and stays prefix-servable
    return 0;
  }

  int pop_block() {
    if (!free_list_.empty()) {
      int blk = free_list_.back();
      free_list_.pop_back();
      return blk;
    }
    if (!lru_.empty()) {  // evict oldest unreferenced cached block
      int blk = lru_.front();
      lru_.pop_front();
      lru_pos_.erase(blk);
      uint64_t h = meta_[blk].content_hash;
      if (h != 0) hash_to_block_.erase(h);
      meta_[blk] = BlockMeta{};
      return blk;
    }
    return -1;
  }

  int block_size_;
  bool prefix_;
  int num_blocks_;
  std::vector<BlockMeta> meta_;
  std::vector<int> free_list_;
  std::list<int> lru_;
  std::unordered_map<int, std::list<int>::iterator> lru_pos_;
  std::unordered_map<uint64_t, int> hash_to_block_;
};

uint64_t salt_seed(const uint8_t* salt, int n) {
  if (n <= 0) return 0;
  uint64_t h = fnv1a(kFnvOffset, salt, static_cast<size_t>(n));
  return h == 0 ? 1 : h;
}

}  // namespace

extern "C" {

void* nxdi_alloc_create(int num_blocks, int block_size, int prefix_caching) {
  return new Allocator(num_blocks, block_size, prefix_caching != 0);
}

void nxdi_alloc_destroy(void* a) { delete static_cast<Allocator*>(a); }

int nxdi_alloc_allocate(void* a, const int64_t* tokens, int n_tokens,
                        int* out_blocks, int max_out, int* out_cached) {
  return static_cast<Allocator*>(a)->allocate(tokens, n_tokens, out_blocks,
                                              max_out, out_cached, 0);
}

int nxdi_alloc_allocate_salted(void* a, const int64_t* tokens, int n_tokens,
                               int* out_blocks, int max_out, int* out_cached,
                               const uint8_t* salt, int salt_len) {
  return static_cast<Allocator*>(a)->allocate(
      tokens, n_tokens, out_blocks, max_out, out_cached,
      salt_seed(salt, salt_len));
}

int nxdi_alloc_extend(void* a, int* blocks, int n_blocks, int new_len,
                      int max_out) {
  return static_cast<Allocator*>(a)->extend(blocks, n_blocks, new_len,
                                            max_out);
}

int nxdi_alloc_free(void* a, const int* blocks, int n) {
  return static_cast<Allocator*>(a)->free_blocks(blocks, n);
}

int nxdi_alloc_invalidate(void* a, const int* blocks, int n) {
  return static_cast<Allocator*>(a)->invalidate_blocks(blocks, n);
}

int nxdi_alloc_num_free(void* a) {
  return static_cast<Allocator*>(a)->num_free();
}

int nxdi_alloc_probe(void* a, const int64_t* tokens, int n_tokens,
                     int* out_blocks, int max_out) {
  return static_cast<Allocator*>(a)->probe(tokens, n_tokens, out_blocks,
                                           max_out, 0);
}

int nxdi_alloc_probe_salted(void* a, const int64_t* tokens, int n_tokens,
                            int* out_blocks, int max_out,
                            const uint8_t* salt, int salt_len) {
  return static_cast<Allocator*>(a)->probe(tokens, n_tokens, out_blocks,
                                           max_out,
                                           salt_seed(salt, salt_len));
}

void nxdi_alloc_set_prefix_caching(void* a, int on) {
  static_cast<Allocator*>(a)->set_prefix_caching(on != 0);
}

}  // extern "C"
