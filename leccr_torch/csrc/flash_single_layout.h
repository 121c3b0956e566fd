// Shared-memory layouts of the Hopper kernels 2 and 3
// (flash_tower_attention.cu, bf16 at Dh = 64): offsets in bytes from the 1024-byte aligned base of a
// launch's dynamic shared memory, and each launch's size with the slack that
// aligns its base.  Every size fits a Hopper block (asserted below), so the
// Hopper variant is never refused for its shared memory.
//
// Tiles are 64 rows x 64 bf16 (8 KB, one TMA box); a head's keys take
// ceil(Lk / 64) boxes of K and of V, at most kSbMaxBoxes (TC_MAX_KEYS = 192).

#pragma once

#include <stddef.h>

namespace {

constexpr int kSbBox = 64 * 64 * 2;  // bytes of a 64 x 64 bf16 tile
constexpr int kSbMaxBoxes = 3;       // 64-key boxes of a head, at most
constexpr int kSbQStages = 4;        // forward: streamed Q tiles in flight

// The 64-key boxes of Lk keys.
constexpr int sb_boxes(int lk) { return (lk + 63) / 64; }

// The forward (kernel 2) over NKB key boxes: kKvBufs heads' K and V boxes,
// the Q ring, beside each head buffer its padding words (2 NKB words of
// bits, then their OR), then the barriers kv_full[kKvBufs],
// kv_empty[kKvBufs], q_full[kSbQStages], q_empty[kSbQStages].
template <int NKB>
struct SbFwdLayout {
  static constexpr int kKvBufs = NKB == kSbMaxBoxes ? 3 : 4;
  static constexpr int kKv = 2 * NKB * kSbBox;  // one head's K, then V
  static constexpr int kQ = kKvBufs * kKv;
  static constexpr int kPadWords = 8;
  static constexpr int kPad = kQ + kSbQStages * kSbBox;
  static constexpr int kBar = kPad + kKvBufs * kPadWords * 4;
  static constexpr int kBars = 2 * kKvBufs + 2 * kSbQStages;
  static constexpr size_t kBytes = 1024 + kBar + 8 * kBars;
};

// The backward (kernel 3) with NW consumer warpgroups (one per key box):
// kKvBufs heads' K and V boxes, the ring of kStages (Q, dO) tile pairs,
// each warpgroup's dSᵀ tile, each warpgroup's side rows (64
// lse·log2(e), then 64 probabilities of a padded key), the row sums'
// partials of the 4 NW warps, the 64 deltas, then the barriers
// kv_full[kKvBufs], full[kStages].  At NW = 1 two blocks fit an SM.
template <int NW>
struct SbBwdLayout {
  static constexpr int kKvBufs = 2;
  static constexpr int kStages = 4;
  static constexpr int kKv = 2 * NW * kSbBox;
  static constexpr int kStage = kKvBufs * kKv;
  static constexpr int kDs = kStage + kStages * 2 * kSbBox;
  static constexpr int kSide = kDs + NW * kSbBox;
  static constexpr int kPart = kSide + NW * 2 * 64 * 4;
  static constexpr int kDelta = kPart + 4 * NW * 64 * 4;
  static constexpr int kBar = kDelta + 64 * 4;
  static constexpr int kBars = kKvBufs + kStages;
  static constexpr size_t kBytes = 1024 + kBar + 8 * kBars;
};

constexpr size_t kSbSmemPerBlock = 232448;  // bytes a Hopper block may use
static_assert(SbFwdLayout<1>::kBytes <= kSbSmemPerBlock &&
                  SbFwdLayout<2>::kBytes <= kSbSmemPerBlock &&
                  SbFwdLayout<3>::kBytes <= kSbSmemPerBlock,
              "kernel 2's shared memory must fit a block at every key count");
static_assert(SbBwdLayout<1>::kBytes <= kSbSmemPerBlock &&
                  SbBwdLayout<2>::kBytes <= kSbSmemPerBlock &&
                  SbBwdLayout<3>::kBytes <= kSbSmemPerBlock,
              "kernel 3's shared memory must fit a block at every key count");

// Dynamic shared memory of launch `which` (0: forward, 1: backward) at Lk
// keys; 0 past kSbMaxBoxes boxes.
constexpr size_t sb_smem_bytes(int which, int lk) {
  const int nb = sb_boxes(lk);
  if (which == 0)
    return nb == 1   ? SbFwdLayout<1>::kBytes
           : nb == 2 ? SbFwdLayout<2>::kBytes
           : nb == 3 ? SbFwdLayout<3>::kBytes
                     : 0;
  return nb == 1   ? SbBwdLayout<1>::kBytes
         : nb == 2 ? SbBwdLayout<2>::kBytes
         : nb == 3 ? SbBwdLayout<3>::kBytes
                   : 0;
}

}  // namespace
