// Preflight (E3) record-generating interpreter core, native implementation.
//
// Copy of the JAX package's csrc/preflight.cpp (the whole file), built for
// the port by openvm_tpu_torch/vm/native.py with g++ on the host.  It is
// host code, not a kernel of the card.
//
// Persistent-handle hybrid design: Python's PreflightInterpreter owns the
// fetch/dispatch loop and ALL extension-opcode semantics; this library
// executes contiguous runs of RV32IM base instructions at native speed and
// YIELDS back to Python at any opcode it does not handle (extension chips,
// phantom, hint stores, terminate).  Word memory, record vectors, the
// touched-word order and per-pc execution counts live in the handle so
// Python and C++ interleave on exactly the same state (Python accesses
// memory through pf_vm_read_words/pf_vm_write_words).
//
// Record layouts mirror openvm_tpu_torch/vm/preflight.py exactly (tested
// equal: tests/test_torch_vm.py).  The reference keeps this layer native too
// (Rust PreflightInterpretedInstance, crates/vm/src/arch/
// interpreter_preflight.rs), and the metered segmentation thresholds mirror
// crates/vm/src/arch/execution_mode/metered/segment_ctx.rs:6-10,135-217
// (max trace height / total cells / total interactions, checked every
// segment_check_insns, plus the powdr fork's POWDR_OPENVM_SEGMENT_DELTA
// timestamp-pressure knob).

#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

namespace {

constexpr uint64_t kP = 2013265921;

enum : int64_t {
  ADD = 0x200, SUB, XOR_, OR_, AND_,
  SLL = 0x205, SRL, SRA,
  SLT = 0x208, SLTU,
  LOADW = 0x210, LOADBU, LOADHU, STOREW, STOREH, STOREB, LOADB, LOADH,
  BEQ = 0x220, BNE,
  BLT = 0x225, BLTU, BGE, BGEU,
  JAL = 0x230, LUI,
  JALR = 0x235,
  AUIPC = 0x240,
  MUL = 0x250, MULH, MULHSU, MULHU,
  DIV = 0x254, DIVU, REM, REMU,
};

// record column widths (must match vm/native.py PREFLIGHT_LAYOUTS)
enum Chip { ALU, LT, SHIFT, MULC, DIVREM, BEQC, BLTC, JALLUI, JALRC, AUIPCC,
            LS, NUM_CHIPS };
constexpr int kWidths[NUM_CHIPS] = {26, 22, 26, 25, 29, 17, 17, 16, 23, 13,
                                    31};

// pf_vm_run statuses
enum : int64_t {
  ST_YIELD = 1,     // pc holds an opcode Python must execute (or TERMINATE)
  ST_INSN_LIMIT = 5,
  ST_SEGMENT_FULL = 8,
  ST_MEM_ERROR = 9,
};

struct RunOut {
  int64_t status;
  int64_t yield_op;   // opcode at pc when status == ST_YIELD
  uint32_t pc;
  uint64_t ts;
  uint64_t instret;
  int64_t n_touched;
  int64_t cpp_cells;  // current total record cells across C++ chips
};

inline int32_t sx32(uint32_t v) { return static_cast<int32_t>(v); }

struct Memory {
  // word-granular: value + last ts + initial value; touched tracked in
  // order.  Pages allocated on demand.
  static constexpr uint32_t PB = 16;
  static constexpr uint32_t PSZ = 1u << PB;
  static constexpr uint32_t PMASK = PSZ - 1;
  struct Page {
    uint32_t val[PSZ];
    uint32_t ts[PSZ];
    uint32_t init[PSZ];
    uint8_t touched[PSZ];
  };
  std::vector<std::unique_ptr<Page>> pages;
  std::vector<int64_t>* touch_order;
  int64_t base_key;  // (as << 27)

  void setup(size_t words, int64_t key, std::vector<int64_t>* order) {
    pages.clear();
    pages.resize((words + PSZ - 1) / PSZ);
    base_key = key;
    touch_order = order;
  }
  size_t n_words() const { return pages.size() * PSZ; }
  inline Page& pg(uint32_t wa) {
    auto& p = pages[wa >> PB];
    if (!p) p.reset(new Page());
    return *p;
  }
  inline void touch(Page& p, uint32_t wa, uint32_t off) {
    if (!p.touched[off]) {
      p.touched[off] = 1;
      p.init[off] = p.val[off];
      touch_order->push_back(base_key | wa);
    }
  }
  inline uint32_t read(uint32_t wa, uint32_t now, uint32_t* prev_ts) {
    Page& p = pg(wa);
    uint32_t off = wa & PMASK;
    touch(p, wa, off);
    *prev_ts = p.ts[off];
    p.ts[off] = now;
    return p.val[off];
  }
  inline uint32_t write(uint32_t wa, uint32_t v, uint32_t now,
                        uint32_t* prev_ts) {
    Page& p = pg(wa);
    uint32_t off = wa & PMASK;
    touch(p, wa, off);
    *prev_ts = p.ts[off];
    uint32_t prev = p.val[off];
    p.val[off] = v;
    p.ts[off] = now;
    return prev;
  }
  inline uint32_t peek_val(uint32_t wa) {
    Page& p = pg(wa);
    return p.val[wa & PMASK];
  }
  inline uint32_t peek_init(uint32_t wa) {
    Page& p = pg(wa);
    return p.init[wa & PMASK];
  }
  inline uint32_t peek_ts(uint32_t wa) {
    Page& p = pg(wa);
    return p.ts[wa & PMASK];
  }
  inline void poke_val(uint32_t wa, uint32_t v) {
    pg(wa).val[wa & PMASK] = v;
  }
  // segment boundary: clear access state, keep values (next segment's
  // initial memory = this segment's final memory)
  void segment_reset() {
    for (auto& p : pages) {
      if (!p) continue;
      std::memset(p->ts, 0, sizeof(p->ts));
      std::memset(p->touched, 0, sizeof(p->touched));
    }
  }
};

struct Rec {
  std::vector<int64_t> buf;  // growable row-major storage
  int64_t n = 0;
  int width = 0;
  bool count_only = false;
  int64_t scratch[64];
  inline int64_t* row() {
    n++;
    if (count_only) return scratch;
    buf.resize(static_cast<size_t>(n) * width);
    return buf.data() + static_cast<size_t>(n - 1) * width;
  }
  void reset() { n = 0; buf.clear(); }
};

inline void put_limbs(int64_t* p, uint32_t v) {
  p[0] = v & 0xFF; p[1] = (v >> 8) & 0xFF;
  p[2] = (v >> 16) & 0xFF; p[3] = (v >> 24) & 0xFF;
}

struct PfVm {
  // program (borrowed; Python keeps the arrays alive on the handle object)
  const int64_t* ops[8];
  int64_t n_insns;
  uint32_t pc_base;
  int64_t* exec_counts;  // borrowed, length n_insns

  Memory regs, mem, pvs;
  std::vector<int64_t> touch_order;
  Rec recs[NUM_CHIPS];

  // metered segmentation (segment_ctx.rs equivalents); 0 = disabled
  int64_t max_height = 0;
  int64_t max_cells = 0;
  int64_t max_interactions = 0;
  int64_t ts_delta = -1;      // POWDR_OPENVM_SEGMENT_DELTA; -1 = off
  int64_t check_insns = 1000; // DEFAULT_SEGMENT_CHECK_INSNS
  int64_t widths[NUM_CHIPS] = {0};       // tracegen widths for cells
  int64_t inters[NUM_CHIPS] = {0};       // interactions per row
  int64_t touched_width = 0;             // boundary+merkle width per word
  int64_t touched_inters = 0;
  uint64_t last_check = 0;

  int64_t mem_error = 0;

  Memory* space(int64_t a_s) {
    if (a_s == 1) return &regs;
    if (a_s == 2) return &mem;
    if (a_s == 3) return &pvs;
    return nullptr;
  }

  int64_t cpp_cells() const {
    int64_t total = 0;
    for (int i = 0; i < NUM_CHIPS; i++) total += recs[i].n * widths[i];
    return total;
  }

  // reference should_segment (segment_ctx.rs:135-217): any chip height
  // over max, total cells over max, total interactions over max, or the
  // powdr timestamp-pressure knob.
  bool should_segment(uint64_t ts, int64_t py_cells, int64_t py_inters,
                      int64_t py_max_height) const {
    if (py_max_height > 0 && max_height && py_max_height > max_height)
      return true;
    int64_t cells = py_cells, inter = py_inters;
    for (int i = 0; i < NUM_CHIPS; i++) {
      if (max_height && recs[i].n > max_height) return true;
      cells += recs[i].n * widths[i];
      inter += (recs[i].n + 1) * inters[i];
    }
    int64_t nt = static_cast<int64_t>(touch_order.size());
    if (max_height && nt > max_height) return true;
    cells += nt * touched_width;
    inter += (nt + 1) * touched_inters;
    if (max_cells && cells > max_cells) return true;
    if (max_interactions && inter > max_interactions) return true;
    if (ts_delta >= 0 && (ts * 12) / 10 > (1ull << 29) - ts_delta)
      return true;
    return false;
  }
};

}  // namespace

extern "C" {

void* pf_vm_create(const int64_t* ops /* 8 x n row-major */, int64_t n_insns,
                   uint32_t pc_base,
                   const int64_t* image_words, const int64_t* image_vals,
                   int64_t n_image, int64_t* exec_counts) {
  PfVm* vm = new PfVm();
  for (int k = 0; k < 8; k++) vm->ops[k] = ops + k * n_insns;
  vm->n_insns = n_insns;
  vm->pc_base = pc_base;
  vm->exec_counts = exec_counts;
  vm->regs.setup(32, 1ll << 27, &vm->touch_order);
  vm->mem.setup(1ull << 27, 2ll << 27, &vm->touch_order);
  vm->pvs.setup(64, 3ll << 27, &vm->touch_order);
  for (int64_t i = 0; i < n_image; i++) {
    vm->mem.poke_val(static_cast<uint32_t>(image_words[i]),
                     static_cast<uint32_t>(image_vals[i]));
  }
  for (int i = 0; i < NUM_CHIPS; i++) vm->recs[i].width = kWidths[i];
  return vm;
}

void pf_vm_destroy(void* h) { delete static_cast<PfVm*>(h); }

void pf_vm_set_mode(void* h, int64_t count_only) {
  PfVm* vm = static_cast<PfVm*>(h);
  for (int i = 0; i < NUM_CHIPS; i++)
    vm->recs[i].count_only = (count_only != 0);
}

void pf_vm_set_limits(void* h, int64_t max_height, int64_t max_cells,
                      int64_t max_interactions, int64_t ts_delta,
                      int64_t check_insns, const int64_t* widths,
                      const int64_t* inters, int64_t touched_width,
                      int64_t touched_inters) {
  PfVm* vm = static_cast<PfVm*>(h);
  vm->max_height = max_height;
  vm->max_cells = max_cells;
  vm->max_interactions = max_interactions;
  vm->ts_delta = ts_delta;
  if (check_insns > 0) vm->check_insns = check_insns;
  if (widths) for (int i = 0; i < NUM_CHIPS; i++) vm->widths[i] = widths[i];
  if (inters) for (int i = 0; i < NUM_CHIPS; i++) vm->inters[i] = inters[i];
  vm->touched_width = touched_width;
  vm->touched_inters = touched_inters;
}

// Execute RV32IM instructions starting at (pc, ts, instret) until:
//  - an opcode this core does not handle (ST_YIELD; pc/ts/instret point AT
//    the unexecuted instruction — Python dispatches it),
//  - the absolute instruction budget (ST_INSN_LIMIT),
//  - the metered segmentation check trips (ST_SEGMENT_FULL; boundary is
//    after the already-executed instructions, reference check_and_segment).
// py_cells / py_inters / py_max_height fold Python-side extension-chip
// accounting into the segmentation check.
RunOut pf_vm_run(void* h, uint32_t pc, uint64_t ts, uint64_t instret,
                 uint64_t max_insns, int64_t py_cells, int64_t py_inters,
                 int64_t py_max_height) {
  PfVm* vm = static_cast<PfVm*>(h);
  const int64_t* opcode = vm->ops[0];
  const int64_t* oa = vm->ops[1];
  const int64_t* ob = vm->ops[2];
  const int64_t* oc = vm->ops[3];
  const int64_t* oe = vm->ops[5];
  const int64_t* of_ = vm->ops[6];
  const int64_t* og = vm->ops[7];
  Memory& regs = vm->regs;
  Memory& mem = vm->mem;
  Memory& pvs = vm->pvs;

  RunOut out{0, 0, pc, ts, instret, 0, 0};
  const bool metered = vm->max_height || vm->max_cells
      || vm->max_interactions || vm->ts_delta >= 0;

  for (;;) {
    if (max_insns && instret >= max_insns) { out.status = ST_INSN_LIMIT; break; }
    if (metered && instret - vm->last_check >= (uint64_t)vm->check_insns) {
      vm->last_check = instret;
      if (vm->should_segment(ts, py_cells, py_inters, py_max_height)) {
        out.status = ST_SEGMENT_FULL;
        break;
      }
    }
    int64_t idx = (static_cast<int64_t>(pc) - vm->pc_base) / 4;
    if (idx < 0 || idx >= vm->n_insns) {
      out.status = ST_YIELD;  // python raises "pc out of bounds"
      out.yield_op = -1;
      break;
    }
    const int64_t op = opcode[idx];
    const uint32_t a = static_cast<uint32_t>(oa[idx]);
    const uint32_t b = static_cast<uint32_t>(ob[idx]);
    const uint32_t c = static_cast<uint32_t>(oc[idx]);
    const uint32_t e = static_cast<uint32_t>(oe[idx]);
    const uint32_t f = static_cast<uint32_t>(of_[idx]);
    const uint32_t g = static_cast<uint32_t>(og[idx]);

    if ((op >= ADD && op <= AND_) || op == SLT || op == SLTU
        || (op >= SLL && op <= SRA)) {
      const bool is_shift = (op >= SLL && op <= SRA);
      const bool is_lt = (op == SLT || op == SLTU);
      const Chip chip = is_shift ? SHIFT : (is_lt ? LT : ALU);
      const int is_imm = (e == 0);
      uint32_t p1, p2 = 0;
      uint32_t x = regs.read(b / 4, ts, &p1);
      uint32_t y;
      if (is_imm) {
        if (is_shift) {
          y = c & 31;
        } else {
          uint32_t imm = c & 0xFFFFFF;
          y = (imm & 0x800000) ? (imm | 0xFF000000) : imm;
        }
      } else {
        y = regs.read(c / 4, ts + 1, &p2);
      }
      uint32_t v;
      int64_t oi;
      if (is_shift) {
        uint32_t sh = y & 31;
        oi = op - SLL;
        v = op == SLL ? (x << sh)
          : op == SRL ? (x >> sh)
          : static_cast<uint32_t>(sx32(x) >> sh);
      } else if (is_lt) {
        oi = op - SLT;
        v = op == SLT ? (sx32(x) < sx32(y)) : (x < y);
      } else {
        oi = op - ADD;
        switch (op) {
          case ADD: v = x + y; break;
          case SUB: v = x - y; break;
          case XOR_: v = x ^ y; break;
          case OR_: v = x | y; break;
          default: v = x & y; break;
        }
      }
      uint32_t pw;
      uint32_t prev = regs.write(a / 4, v, ts + 2, &pw);
      int64_t* r = vm->recs[chip].row();
      r[0] = pc; r[1] = ts; r[2] = oi; r[3] = is_imm;
      r[4] = a / 4; r[5] = b / 4; r[6] = is_imm ? c : c / 4;
      put_limbs(r + 7, x);
      put_limbs(r + 11, y);
      if (chip == LT) {
        r[15] = p1; r[16] = is_imm ? 0 : p2; r[17] = pw;
        put_limbs(r + 18, prev);
      } else {
        put_limbs(r + 15, v);
        r[19] = p1; r[20] = is_imm ? 0 : p2; r[21] = pw;
        put_limbs(r + 22, prev);
      }
      pc += 4; ts += 3;

    } else if ((op == MUL) || (op >= MULH && op <= MULHU)
               || (op >= DIV && op <= REMU)) {
      uint32_t p1, p2, pw;
      uint32_t x = regs.read(b / 4, ts, &p1);
      uint32_t y = regs.read(c / 4, ts + 1, &p2);
      if (op >= DIV && op <= REMU) {
        int64_t oi = op - DIV;
        bool is_signed = (oi == 0 || oi == 2);
        uint32_t q, rr;
        if (y == 0) {
          q = 0xFFFFFFFFu; rr = x;
        } else if (is_signed && x == 0x80000000u && y == 0xFFFFFFFFu) {
          q = 0x80000000u; rr = 0;
        } else if (is_signed) {
          int32_t xs = sx32(x), ys = sx32(y);
          int32_t qs = xs / ys;  // C++ truncates toward zero = RISC-V
          q = static_cast<uint32_t>(qs);
          rr = static_cast<uint32_t>(xs % ys);
        } else {
          q = x / y; rr = x % y;
        }
        uint32_t v = (oi == 0 || oi == 1) ? q : rr;
        uint32_t prev = regs.write(a / 4, v, ts + 2, &pw);
        int64_t* r = vm->recs[DIVREM].row();
        r[0] = pc; r[1] = ts; r[2] = oi; r[3] = a / 4; r[4] = b / 4;
        r[5] = c / 4;
        put_limbs(r + 6, x); put_limbs(r + 10, y);
        put_limbs(r + 14, q); put_limbs(r + 18, rr);
        r[22] = p1; r[23] = p2; r[24] = pw;
        put_limbs(r + 25, prev);
      } else {
        int64_t oi;
        uint32_t v;
        if (op == MUL) { oi = 0; v = x * y; }
        else {
          oi = op - MULH + 1;
          int64_t xs = sx32(x), ys = sx32(y);
          uint64_t prod = op == MULH ? static_cast<uint64_t>(xs * ys)
                        : op == MULHSU ? static_cast<uint64_t>(
                              xs * static_cast<int64_t>(y))
                        : static_cast<uint64_t>(x) * y;
          v = static_cast<uint32_t>(prod >> 32);
        }
        uint32_t prev = regs.write(a / 4, v, ts + 2, &pw);
        int64_t* r = vm->recs[MULC].row();
        r[0] = pc; r[1] = ts; r[2] = oi; r[3] = a / 4; r[4] = b / 4;
        r[5] = c / 4;
        put_limbs(r + 6, x); put_limbs(r + 10, y); put_limbs(r + 14, v);
        r[18] = p1; r[19] = p2; r[20] = pw;
        put_limbs(r + 21, prev);
      }
      pc += 4; ts += 3;

    } else if (op == BEQ || op == BNE || (op >= BLT && op <= BGEU)) {
      const bool is_eq = (op == BEQ || op == BNE);
      uint32_t p1, p2;
      uint32_t x = regs.read(a / 4, ts, &p1);
      uint32_t y = regs.read(b / 4, ts + 1, &p2);
      bool taken;
      int64_t oi;
      if (is_eq) {
        oi = op - BEQ;
        taken = (op == BEQ) == (x == y);
      } else {
        oi = op - BLT;
        bool lt = (oi == 0 || oi == 2) ? (sx32(x) < sx32(y)) : (x < y);
        taken = (oi <= 1) ? lt : !lt;
      }
      int32_t off = c > kP / 2 ? static_cast<int32_t>(c - kP) : c;
      uint32_t to_pc = taken ? pc + off : pc + 4;
      int64_t* r = vm->recs[is_eq ? BEQC : BLTC].row();
      r[0] = pc; r[1] = ts; r[2] = oi; r[3] = a / 4; r[4] = b / 4; r[5] = c;
      put_limbs(r + 6, x); put_limbs(r + 10, y);
      r[14] = to_pc; r[15] = p1; r[16] = p2;
      pc = to_pc; ts += 2;

    } else if (op == JAL || op == LUI) {
      const bool is_jal = (op == JAL);
      const int nw = (f != 0);
      uint32_t rd_val, to_pc;
      if (is_jal) {
        rd_val = pc + 4;
        int32_t off = c > kP / 2 ? static_cast<int32_t>(c - kP) : c;
        to_pc = pc + off;
      } else {
        rd_val = c << 12;
        to_pc = pc + 4;
      }
      uint32_t pw = 0, prev = 0;
      if (nw) prev = regs.write(a / 4, rd_val, ts, &pw);
      int64_t* r = vm->recs[JALLUI].row();
      r[0] = pc; r[1] = ts; r[2] = is_jal ? 0 : 1; r[3] = a / 4; r[4] = c;
      r[5] = nw;
      put_limbs(r + 6, nw ? rd_val : 0);
      r[10] = to_pc; r[11] = pw;
      put_limbs(r + 12, prev);
      pc = to_pc; ts += 1;

    } else if (op == JALR) {
      const int nw = (f != 0);
      uint32_t p1;
      uint32_t x = regs.read(b / 4, ts, &p1);
      uint32_t imm = (c & 0xFFFF) | (g ? 0xFFFF0000u : 0);
      uint32_t target = x + imm;
      uint32_t lsb = target & 1;
      uint32_t to_pc = target & ~1u;
      uint32_t rd_val = pc + 4;
      uint32_t pw = 0, prev = 0;
      if (nw) prev = regs.write(a / 4, rd_val, ts + 1, &pw);
      int64_t* r = vm->recs[JALRC].row();
      r[0] = pc; r[1] = ts; r[2] = a / 4; r[3] = b / 4; r[4] = c; r[5] = g;
      r[6] = nw;
      put_limbs(r + 7, x);
      put_limbs(r + 11, nw ? rd_val : 0);
      r[15] = to_pc; r[16] = lsb; r[17] = p1; r[18] = pw;
      put_limbs(r + 19, prev);
      pc = to_pc; ts += 2;

    } else if (op == AUIPC) {
      uint32_t rd_val = pc + (c << 8);
      uint32_t pw;
      uint32_t prev = regs.write(a / 4, rd_val, ts, &pw);
      int64_t* r = vm->recs[AUIPCC].row();
      r[0] = pc; r[1] = ts; r[2] = a / 4; r[3] = c;
      put_limbs(r + 4, rd_val);
      r[8] = pw;
      put_limbs(r + 9, prev);
      pc += 4; ts += 1;

    } else if (op >= LOADW && op <= LOADH) {
      const int64_t oi = op - LOADW;
      const bool is_load = (oi < 3 || oi > 5);
      const int nw = (f != 0);
      uint32_t p1, p2, pw = 0;
      uint32_t x = regs.read(b / 4, ts, &p1);
      uint32_t imm = (c & 0xFFFF) | (g ? 0xFFFF0000u : 0);
      uint32_t full = x + imm;
      uint32_t wa = full >> 2, shift = full & 3;
      uint32_t data2, new3, prev = 0;
      if (is_load) {
        if (e != 2 || wa >= (1u << 27)) {
          vm->mem_error = 1;
          out.status = ST_MEM_ERROR;
          goto stop;
        }
        data2 = mem.read(wa, ts + 1, &p2);
        const uint8_t* db = reinterpret_cast<const uint8_t*>(&data2);
        switch (op) {
          case LOADW: new3 = data2; break;
          case LOADBU: new3 = db[shift]; break;
          case LOADHU: new3 = db[shift] | (db[shift + 1] << 8); break;
          case LOADB: new3 = static_cast<uint32_t>(
                          static_cast<int8_t>(db[shift])); break;
          default: new3 = static_cast<uint32_t>(static_cast<int16_t>(
                       db[shift] | (db[shift + 1] << 8))); break;
        }
        if (nw) prev = regs.write(a / 4, new3, ts + 2, &pw);
      } else {
        data2 = regs.read(a / 4, ts + 1, &p2);
        Memory* m = nullptr;
        if (e == 2) m = &mem;
        else if (e == 3) m = &pvs;
        if (!m || (e == 2 && wa >= (1u << 27)) || (e == 3 && wa >= 64)) {
          vm->mem_error = 1;
          out.status = ST_MEM_ERROR;
          goto stop;
        }
        uint32_t cur = m->peek_val(wa);
        uint8_t nb[4];
        std::memcpy(nb, &cur, 4);
        const uint8_t* vb = reinterpret_cast<const uint8_t*>(&data2);
        if (op == STOREW) { std::memcpy(nb, vb, 4); }
        else if (op == STOREH) { nb[shift] = vb[0]; nb[shift + 1] = vb[1]; }
        else { nb[shift] = vb[0]; }
        std::memcpy(&new3, nb, 4);
        prev = m->write(wa, new3, ts + 2, &pw);
      }
      {
        int64_t* r = vm->recs[LS].row();
        r[0] = pc; r[1] = ts; r[2] = oi; r[3] = a / 4; r[4] = b / 4;
        r[5] = c; r[6] = g; r[7] = e; r[8] = nw;
        put_limbs(r + 9, x);
        r[13] = wa; r[14] = shift & 1; r[15] = shift >> 1;
        put_limbs(r + 16, data2);
        put_limbs(r + 20, new3);
        r[24] = p1; r[25] = p2; r[26] = is_load && !nw ? 0 : pw;
        put_limbs(r + 27, is_load && !nw ? 0 : prev);
      }
      pc += 4; ts += 3;

    } else {
      // TERMINATE, PHANTOM, HINT_*, every extension opcode: Python's turn
      out.status = ST_YIELD;
      out.yield_op = op;
      break;
    }
    vm->exec_counts[idx]++;
    instret++;
  }
stop:
  out.pc = pc;
  out.ts = ts;
  out.instret = instret;
  out.n_touched = static_cast<int64_t>(vm->touch_order.size());
  out.cpp_cells = vm->cpp_cells();
  return out;
}

// Segmentation check entry for Python-dispatched instructions (extension
// chips): returns 1 if the segment should end at the current instret.
int64_t pf_vm_should_segment(void* h, uint64_t ts, int64_t py_cells,
                             int64_t py_inters, int64_t py_max_height) {
  PfVm* vm = static_cast<PfVm*>(h);
  return vm->should_segment(ts, py_cells, py_inters, py_max_height) ? 1 : 0;
}

int64_t pf_vm_rec_count(void* h, int64_t chip) {
  return static_cast<PfVm*>(h)->recs[chip].n;
}

void pf_vm_rec_copy(void* h, int64_t chip, int64_t* out_buf) {
  Rec& r = static_cast<PfVm*>(h)->recs[chip];
  if (!r.count_only && r.n)
    std::memcpy(out_buf, r.buf.data(),
                static_cast<size_t>(r.n) * r.width * sizeof(int64_t));
}

int64_t pf_vm_touched_count(void* h) {
  return static_cast<int64_t>(static_cast<PfVm*>(h)->touch_order.size());
}

// rows: as, wa, i0..3, f0..3, ts (11 cols, insertion order)
void pf_vm_touched_copy(void* h, int64_t* out) {
  PfVm* vm = static_cast<PfVm*>(h);
  int64_t nt = 0;
  for (int64_t key : vm->touch_order) {
    int64_t a_s = key >> 27;
    uint32_t wa = key & ((1 << 27) - 1);
    Memory* m = vm->space(a_s);
    int64_t* row = out + nt * 11;
    row[0] = a_s;
    row[1] = wa;
    put_limbs(row + 2, m->peek_init(wa));
    put_limbs(row + 6, m->peek_val(wa));
    row[10] = m->peek_ts(wa);
    nt++;
  }
}

// Segment boundary: drop records + touched/ts state, keep memory values,
// zero the per-pc execution counts.  Streams and pc/ts ownership stay on
// the Python side.
void pf_vm_segment_reset(void* h) {
  PfVm* vm = static_cast<PfVm*>(h);
  for (int i = 0; i < NUM_CHIPS; i++) vm->recs[i].reset();
  vm->touch_order.clear();
  vm->regs.segment_reset();
  vm->mem.segment_reset();
  vm->pvs.segment_reset();
  std::memset(vm->exec_counts, 0, vm->n_insns * sizeof(int64_t));
  vm->last_check = 0;
}

// --- memory access for Python-dispatched (extension) instructions --------

int64_t pf_vm_mem_error(void* h) { return static_cast<PfVm*>(h)->mem_error; }

void pf_vm_read_words(void* h, int64_t a_s, const int64_t* was,
                      const int64_t* nows, int64_t n, int64_t* vals,
                      int64_t* prev_ts) {
  PfVm* vm = static_cast<PfVm*>(h);
  Memory* m = vm->space(a_s);
  if (!m) { vm->mem_error = 1; return; }
  size_t limit = m->n_words();
  for (int64_t i = 0; i < n; i++) {
    uint32_t wa = static_cast<uint32_t>(was[i]);
    if (wa >= limit) { vm->mem_error = 1; return; }
    uint32_t pts;
    vals[i] = m->read(wa, static_cast<uint32_t>(nows[i]), &pts);
    prev_ts[i] = pts;
  }
}

void pf_vm_write_words(void* h, int64_t a_s, const int64_t* was,
                       const int64_t* vals, const int64_t* nows, int64_t n,
                       int64_t* prevs, int64_t* prev_ts) {
  PfVm* vm = static_cast<PfVm*>(h);
  Memory* m = vm->space(a_s);
  if (!m) { vm->mem_error = 1; return; }
  size_t limit = m->n_words();
  for (int64_t i = 0; i < n; i++) {
    uint32_t wa = static_cast<uint32_t>(was[i]);
    if (wa >= limit) { vm->mem_error = 1; return; }
    uint32_t pts;
    prevs[i] = m->write(wa, static_cast<uint32_t>(vals[i]),
                        static_cast<uint32_t>(nows[i]), &pts);
    prev_ts[i] = pts;
  }
}

int64_t pf_vm_peek_word(void* h, int64_t a_s, int64_t wa) {
  PfVm* vm = static_cast<PfVm*>(h);
  Memory* m = vm->space(a_s);
  if (!m || static_cast<size_t>(wa) >= m->n_words()) {
    vm->mem_error = 1;
    return 0;
  }
  return m->peek_val(static_cast<uint32_t>(wa));
}

}  // extern "C"
