// Bit-accurate integer model of the Minn-RTL preamble detector datapath.
//
// This is the framework's native-runtime counterpart of the reference's
// SystemVerilog modules (the reference's only native components):
//   * delay line with zero-output priming fill   (ref/minn_delay_line.sv:49-78)
//   * sliding running sum, valid once filled     (ref/minn_running_sum.sv:50-99)
//   * per-antenna correlator path                (ref/minn_antenna_path.sv:33-194)
//   * top-level combine / clip / smooth / divide-free threshold /
//     gate+hysteresis+peak FSM                   (ref/minn_preamble_detector.sv:247-384)
//
// All arithmetic is exact integer (int64 accumulators; the RTL's growing
// bit-widths fit comfortably): int12-range IQ in, quarter products and powers
// in int32, window sums in int64, smoothing via the RTL's arithmetic-shift
// update s += (x - s) >>> shift, and the division-free threshold compare
// (smooth << frac_bits) >= energy * thresh.  It serves as the independent
// integer oracle for the float kernels -- the same role the
// Verilator-compiled RTL plays for the reference's NumPy golden model
// (ref/test_minn_preamble_detector.py) -- and as a host-side streaming
// detector for hosts without an accelerator.
//
// Build: g++ -O3 -shared -fPIC -o libminn_rtl.so minn_rtl.cc

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Depth-D delay line: outputs 0 until D samples have been written
// (ref/minn_delay_line.sv:58-74).
template <typename T>
class DelayLine {
 public:
  explicit DelayLine(int64_t depth) : buf_(depth, T(0)), depth_(depth) {}
  T step(T in) {
    if (depth_ == 0) return in;
    T out = (fill_ >= depth_) ? buf_[ptr_] : T(0);
    buf_[ptr_] = in;
    ptr_ = (ptr_ + 1) % depth_;
    if (fill_ < depth_) ++fill_;
    return out;
  }

 private:
  std::vector<T> buf_;
  int64_t depth_;
  int64_t ptr_ = 0;
  int64_t fill_ = 0;
};

// Sliding sum over the last D samples; zero-primed history
// (ref/minn_running_sum.sv:50-99).
class RunningSum {
 public:
  explicit RunningSum(int64_t depth) : line_(depth) {}
  int64_t step(int64_t in) {
    acc_ += in - line_.step(in);
    return acc_;
  }

 private:
  DelayLine<int64_t> line_;
  int64_t acc_ = 0;
};

// Per-antenna correlator path (ref/minn_antenna_path.sv:33-194): Q-delay of
// I/Q -> quarter product & power -> Q running sums -> Q-delayed corr tap and
// Q/2Q-delayed energy taps.
class AntennaPath {
 public:
  explicit AntennaPath(int64_t q)
      : di_(q), dq_(q), corr_win_(q), en_win_(q), corr_d_(q), en_d_(q),
        en_d2_(2 * q) {}

  struct Taps {
    int64_t corr_recent, corr_previous;
    int64_t energy_recent, energy_previous, energy_previous2;
  };

  Taps step(int32_t i_in, int32_t q_in) {
    int32_t id = di_.step(i_in);
    int32_t qd = dq_.step(q_in);
    int64_t qp = int64_t(i_in) * id + int64_t(q_in) * qd;
    int64_t pw = int64_t(i_in) * i_in + int64_t(q_in) * q_in;
    Taps t;
    t.corr_recent = corr_win_.step(qp);
    t.energy_recent = en_win_.step(pw);
    t.corr_previous = corr_d_.step(t.corr_recent);
    t.energy_previous = en_d_.step(t.energy_recent);
    t.energy_previous2 = en_d2_.step(t.energy_recent);
    return t;
  }

 private:
  DelayLine<int32_t> di_, dq_;
  RunningSum corr_win_, en_win_;
  DelayLine<int64_t> corr_d_, en_d_, en_d2_;
};

}  // namespace

extern "C" {

typedef struct {
  int32_t quarter_len;
  int32_t smooth_shift;
  int32_t frac_bits;
  int64_t threshold_value;  // Q(frac_bits) fixed point
  int32_t hysteresis;
  int32_t emit_unclosed;  // bool
  int32_t timing_offset;  // added to reported peak index
} MinnRtlParams;

// Streaming detection over planar int16 IQ, layout iq[branch][plane][n]
// (plane 0 = I, plane 1 = Q).  Event outputs have capacity `cap`; the return
// value is the TOTAL number of gates seen (callers clip / detect overflow).
// Optional per-sample traces (pass nullptr to skip): corr_total (pre-clip),
// energy_total, smooth, above -- the exact integer counterparts of the float
// datapath's MinnRTLFastState.
int64_t minn_rtl_detect_i16(
    const int16_t* iq, int64_t n, int32_t branches, const MinnRtlParams* p,
    int32_t* ev_start, int32_t* ev_close, int32_t* ev_peak,
    double* ev_peak_val, uint8_t* ev_closed, int32_t cap,
    int64_t* trace_corr, int64_t* trace_energy, int64_t* trace_smooth,
    uint8_t* trace_above) {
  const int64_t q = p->quarter_len;
  const int64_t valid_from = (3 * q - 1 > 0) ? 3 * q - 1 : 0;
  const int h = (p->hysteresis > 1) ? p->hysteresis : 1;

  std::vector<AntennaPath> paths;
  paths.reserve(branches);
  for (int32_t b = 0; b < branches; ++b) paths.emplace_back(q);

  int64_t smooth = 0;
  bool gate_open = false;
  int64_t gate_start = 0, peak_idx = 0, peak_val = 0;
  int low_count = 0;
  int64_t total_events = 0;

  auto emit = [&](int64_t close_idx, bool closed) {
    if (total_events < cap) {
      ev_start[total_events] = int32_t(gate_start);
      ev_close[total_events] = int32_t(close_idx);
      ev_peak[total_events] = int32_t(peak_idx + p->timing_offset);
      ev_peak_val[total_events] = double(peak_val);
      ev_closed[total_events] = closed ? 1 : 0;
    }
    ++total_events;
  };

  for (int64_t idx = 0; idx < n; ++idx) {
    int64_t corr_total = 0;
    int64_t energy_total = 0;
    for (int32_t b = 0; b < branches; ++b) {
      const int16_t* base = iq + int64_t(b) * 2 * n;
      AntennaPath::Taps t = paths[b].step(base[idx], base[n + idx]);
      corr_total += t.corr_recent + t.corr_previous;
      energy_total += t.energy_recent + t.energy_previous + t.energy_previous2;
    }
    // clip negative correlation (ref/minn_preamble_detector.sv:265-272)
    int64_t corr_pos = corr_total > 0 ? corr_total : 0;
    bool valid = idx >= valid_from;

    // exponential smoothing with arithmetic shift, frozen while invalid
    // (ref/minn_preamble_detector.sv:277-300)
    if (valid) {
      if (p->smooth_shift == 0) {
        smooth = corr_pos;
      } else {
        smooth += (corr_pos - smooth) >> p->smooth_shift;
      }
    }

    // division-free threshold (ref/minn_preamble_detector.sv:305-325)
    bool above = valid && ((smooth << p->frac_bits) >=
                           energy_total * p->threshold_value);

    if (trace_corr) trace_corr[idx] = corr_total;
    if (trace_energy) trace_energy[idx] = energy_total;
    if (trace_smooth) trace_smooth[idx] = smooth;
    if (trace_above) trace_above[idx] = above ? 1 : 0;

    // gate / peak / hysteresis FSM (ref/minn_preamble_detector.sv:337-384;
    // '>=' update = latest-peak tie break, reference minn_rtl.py:783)
    int64_t track = corr_pos;
    if (!gate_open) {
      if (above) {
        gate_open = true;
        gate_start = idx;
        peak_idx = idx;
        peak_val = track;
        low_count = 0;
      }
    } else {
      if (track >= peak_val) {
        peak_val = track;
        peak_idx = idx;
      }
      if (above) {
        low_count = 0;
      } else {
        if (++low_count >= h) {
          emit(idx, true);
          gate_open = false;
        }
      }
    }
  }
  if (gate_open && p->emit_unclosed) emit(n - 1, false);
  return total_events;
}

// ---------------------------------------------------------------------------
// [A][A] detector -- the FPGA design doc's fixed-point pipeline
// (reference docs/aa_preamble_sync_design.md sections 5-9: recursive
//  P[n] = P[n-1] + x[n] x*[n-L] - x[n-L] x*[n-2L], 40-bit P accumulators,
//  R over the current window, division-free M >= theta compare on
//  |P|^2 * 2^frac >= theta_q * R^2, gate/hysteresis/peak on |P|^2,
//  CFO from angle(P_peak), frame start = peak - 2L + 1)
// ---------------------------------------------------------------------------

typedef struct {
  int32_t half_len;       // L
  int64_t threshold_q;    // theta * 2^frac_bits (e.g. 0.15 * 2^15 = 4915)
  int32_t frac_bits;
  int32_t hysteresis;
  int32_t emit_unclosed;  // bool
} AAParams;

namespace {

struct AAPath {
  DelayLine<int32_t> di, dq;   // x[n-L]
  RunningSum p_re, p_im, r;    // L-window sums (== the recursive update)
  explicit AAPath(int64_t L) : di(L), dq(L), p_re(L), p_im(L), r(L) {}
};

}  // namespace

// Streaming [A][A] detection over planar int16 IQ (iq[branch][plane][n]).
// Event peak values are |P|^2 as double (they exceed int64 at full scale);
// ev_p_re/ev_p_im return P at the peak for host-side CFO estimation.
// Returns total gates seen.
int64_t aa_detect_i16(
    const int16_t* iq, int64_t n, int32_t branches, const AAParams* p,
    int32_t* ev_start, int32_t* ev_close, int32_t* ev_peak,
    double* ev_peak_val, double* ev_p_re, double* ev_p_im,
    uint8_t* ev_closed, int32_t cap,
    int64_t* tr_p_re, int64_t* tr_p_im, int64_t* tr_r, uint8_t* tr_above) {
  const int64_t L = p->half_len;
  const int h = (p->hysteresis > 1) ? p->hysteresis : 1;

  std::vector<AAPath> paths;
  paths.reserve(branches);
  for (int32_t b = 0; b < branches; ++b) paths.emplace_back(L);

  bool gate_open = false;
  int64_t gate_start = 0, peak_idx = 0;
  double peak_val = 0.0, peak_p_re = 0.0, peak_p_im = 0.0;
  int low_count = 0;
  int64_t total_events = 0;

  auto emit = [&](int64_t close_idx, bool closed) {
    if (total_events < cap) {
      ev_start[total_events] = int32_t(gate_start);
      ev_close[total_events] = int32_t(close_idx);
      ev_peak[total_events] = int32_t(peak_idx);
      ev_peak_val[total_events] = peak_val;
      ev_p_re[total_events] = peak_p_re;
      ev_p_im[total_events] = peak_p_im;
      ev_closed[total_events] = closed ? 1 : 0;
    }
    ++total_events;
  };

  for (int64_t idx = 0; idx < n; ++idx) {
    int64_t P_re = 0, P_im = 0, R = 0;
    for (int32_t b = 0; b < branches; ++b) {
      const int16_t* base = iq + int64_t(b) * 2 * n;
      int32_t i_in = base[idx], q_in = base[n + idx];
      AAPath& ap = paths[b];
      int32_t id = ap.di.step(i_in);
      int32_t qd = ap.dq.step(q_in);
      // x[n] * conj(x[n-L]) in planar integers
      int64_t pr = int64_t(i_in) * id + int64_t(q_in) * qd;
      int64_t pi = int64_t(q_in) * id - int64_t(i_in) * qd;
      int64_t pw = int64_t(i_in) * i_in + int64_t(q_in) * q_in;
      // combine antennas AFTER the per-antenna window sums
      // (doc section 6: P and R summed across antennas)
      P_re += ap.p_re.step(pr);
      P_im += ap.p_im.step(pi);
      R += ap.r.step(pw);
    }
    bool valid = idx >= L;
    // |P|^2 and R^2 exceed int64 at full scale -- 128-bit compare
    unsigned __int128 p_sq =
        (unsigned __int128)(P_re < 0 ? -P_re : P_re) * (P_re < 0 ? -P_re : P_re)
        + (unsigned __int128)(P_im < 0 ? -P_im : P_im) * (P_im < 0 ? -P_im : P_im);
    unsigned __int128 r_sq = (unsigned __int128)R * (unsigned __int128)R;
    bool above = valid && R > 0 &&
                 (p_sq << p->frac_bits) >= r_sq * (unsigned __int128)p->threshold_q;

    if (tr_p_re) tr_p_re[idx] = P_re;
    if (tr_p_im) tr_p_im[idx] = P_im;
    if (tr_r) tr_r[idx] = R;
    if (tr_above) tr_above[idx] = above ? 1 : 0;

    // gate FSM peak-tracks |P|^2 with a strict '>' update ('first' ties,
    // reference sync_aa.py:522-529)
    double track = double(P_re) * double(P_re) + double(P_im) * double(P_im);
    if (!gate_open) {
      if (above) {
        gate_open = true;
        gate_start = idx;
        peak_idx = idx;
        peak_val = track;
        peak_p_re = double(P_re);
        peak_p_im = double(P_im);
        low_count = 0;
      }
    } else {
      if (track > peak_val) {
        peak_val = track;
        peak_idx = idx;
        peak_p_re = double(P_re);
        peak_p_im = double(P_im);
      }
      if (above) {
        low_count = 0;
      } else {
        if (++low_count >= h) {
          emit(idx, true);
          gate_open = false;
        }
      }
    }
  }
  if (gate_open && p->emit_unclosed) emit(n - 1, false);
  return total_events;
}

// Library version/ABI tag for the ctypes wrapper's staleness check.
int32_t minn_rtl_abi_version(void) { return 2; }

}  // extern "C"
