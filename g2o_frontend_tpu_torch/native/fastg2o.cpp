// Fast .g2o log parser — the native IO path of g2o_frontend_tpu.
//
// Plays the role of the reference's C++ log readers (g2o's load(), the boss
// LogReader "boss/log_reader.h", sensor_data readers): a single-pass
// tokenizer over an in-memory buffer producing packed double arrays that the
// Python side wraps as numpy without copies beyond one memcpy per table.
//
// Exposed C ABI (ctypes-friendly):
//   G2OResult* fastg2o_parse(const char* buf, long len);
//   void       fastg2o_free(G2OResult*);
//
// Record coverage matches io/g2o.py: VERTEX_SE2, VERTEX_XY,
// VERTEX_SE3:QUAT, EDGE_SE2, EDGE_SE2_XY, EDGE_SE3:QUAT, FIX,
// PARAMS_SE3OFFSET, LASER_ROBOT_DATA (variable-length ranges flattened with
// per-scan offsets), DATA_FEATURE_POINTXY (attached to the last vertex),
// and the line-SLAM records VERTEX_LINE2D, VERTEX_EXTREME_XY,
// EDGE_SE2_LINE2D, EDGE_LINE2D_POINTXY (g2o_line_addons graphs).

#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

struct Table {
  std::vector<double> data;
  long cols = 0;
  long rows() const { return cols ? (long)data.size() / cols : 0; }
};

// fast float parse: strtod with advancing cursor
static inline bool next_tok(const char*& p, const char* end, const char*& tok,
                            long& tok_len) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  if (p >= end || *p == '\n') return false;
  tok = p;
  while (p < end && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') ++p;
  tok_len = p - tok;
  return true;
}

static inline double to_d(const char* tok, long len) {
  char tmp[64];
  long n = len < 63 ? len : 63;
  memcpy(tmp, tok, n);
  tmp[n] = 0;
  return strtod(tmp, nullptr);
}

static inline bool tok_is(const char* tok, long len, const char* s) {
  long sl = strlen(s);
  return len == sl && memcmp(tok, s, sl) == 0;
}

}  // namespace

extern "C" {

struct CTable {
  double* data;
  long rows;
  long cols;
};

struct G2OResult {
  CTable vertex_se2;    // id x y th
  CTable vertex_xy;     // id x y
  CTable vertex_se3;    // id x y z qx qy qz qw
  CTable edge_se2;      // i j dx dy dth i11 i12 i13 i22 i23 i33
  CTable edge_se2_xy;   // i j dx dy i11 i12 i22
  CTable edge_se3;      // i j 7meas 21info
  CTable fixed;         // id
  CTable params;        // id 7
  CTable features;      // vertex x y i11 i12 i22
  CTable laser_meta;    // vertex paramIdx firstAngle fov res maxr acc offset n
  CTable laser_ranges;  // flat
  CTable vertex_line2d;   // id theta rho p1 p2
  CTable vertex_extreme;  // id x y density
  CTable edge_se2_line2d; // i j dth drho i11 i12 i22
  CTable edge_line2d_xy;  // i j meas info
};

extern "C" long fastg2o_abi() { return 2; }

static void fill(CTable& c, Table& t) {
  c.rows = t.rows();
  c.cols = t.cols;
  if (t.data.empty()) {
    c.data = nullptr;
    return;
  }
  c.data = (double*)malloc(t.data.size() * sizeof(double));
  memcpy(c.data, t.data.data(), t.data.size() * sizeof(double));
}

G2OResult* fastg2o_parse(const char* buf, long len) {
  Table v2{{}, 4}, vxy{{}, 3}, v3{{}, 8}, e2{{}, 11}, exy{{}, 7}, e3{{}, 30},
      fx{{}, 1}, pr{{}, 8}, ft{{}, 6}, lm{{}, 9}, lr{{}, 1},
      vl{{}, 5}, vx{{}, 4}, esl{{}, 7}, elx{{}, 4};
  const char* p = buf;
  const char* end = buf + len;
  double last_vertex = -1;

  std::vector<double> vals;
  vals.reserve(1200);
  while (p < end) {
    const char* tok;
    long tl;
    if (!next_tok(p, end, tok, tl)) {
      if (p < end) ++p;  // skip newline
      continue;
    }
    // gather the rest of the line's numeric tokens lazily per record type
    auto read_n = [&](long n, std::vector<double>& out) {
      out.clear();
      const char* t;
      long l;
      for (long k = 0; k < n; k++) {
        if (!next_tok(p, end, t, l)) return false;
        out.push_back(to_d(t, l));
      }
      return true;
    };
    auto skip_line = [&]() {
      while (p < end && *p != '\n') ++p;
    };

    if (tok_is(tok, tl, "VERTEX_SE2")) {
      if (read_n(4, vals)) {
        last_vertex = vals[0];
        v2.data.insert(v2.data.end(), vals.begin(), vals.end());
      }
    } else if (tok_is(tok, tl, "VERTEX_XY")) {
      if (read_n(3, vals)) {
        last_vertex = vals[0];
        vxy.data.insert(vxy.data.end(), vals.begin(), vals.end());
      }
    } else if (tok_is(tok, tl, "VERTEX_SE3:QUAT") || tok_is(tok, tl, "VERTEX_SE3")) {
      if (read_n(8, vals)) {
        last_vertex = vals[0];
        v3.data.insert(v3.data.end(), vals.begin(), vals.end());
      }
    } else if (tok_is(tok, tl, "EDGE_SE2")) {
      if (read_n(11, vals))
        e2.data.insert(e2.data.end(), vals.begin(), vals.end());
    } else if (tok_is(tok, tl, "EDGE_SE2_XY")) {
      if (read_n(7, vals))
        exy.data.insert(exy.data.end(), vals.begin(), vals.end());
    } else if (tok_is(tok, tl, "EDGE_SE3:QUAT") || tok_is(tok, tl, "EDGE_SE3")) {
      if (read_n(30, vals))
        e3.data.insert(e3.data.end(), vals.begin(), vals.end());
    } else if (tok_is(tok, tl, "VERTEX_LINE2D")) {
      // id theta rho [p1 p2]
      if (read_n(3, vals)) {
        last_vertex = vals[0];
        double p1 = -1, p2 = -1;
        const char* t; long l;
        if (next_tok(p, end, t, l)) { p1 = to_d(t, l);
          if (next_tok(p, end, t, l)) p2 = to_d(t, l); }
        vl.data.insert(vl.data.end(), vals.begin(), vals.end());
        vl.data.push_back(p1);
        vl.data.push_back(p2);
      }
    } else if (tok_is(tok, tl, "VERTEX_EXTREME_XY")) {
      // id x y [density]
      if (read_n(3, vals)) {
        last_vertex = vals[0];
        double den = 1.0;
        const char* t; long l;
        if (next_tok(p, end, t, l)) den = to_d(t, l);
        vx.data.insert(vx.data.end(), vals.begin(), vals.end());
        vx.data.push_back(den);
      }
    } else if (tok_is(tok, tl, "EDGE_SE2_LINE2D")) {
      if (read_n(7, vals))
        esl.data.insert(esl.data.end(), vals.begin(), vals.end());
    } else if (tok_is(tok, tl, "EDGE_LINE2D_POINTXY")) {
      if (read_n(4, vals))
        elx.data.insert(elx.data.end(), vals.begin(), vals.end());
    } else if (tok_is(tok, tl, "FIX")) {
      const char* t;
      long l;
      while (next_tok(p, end, t, l)) fx.data.push_back(to_d(t, l));
    } else if (tok_is(tok, tl, "PARAMS_SE3OFFSET")) {
      if (read_n(8, vals))
        pr.data.insert(pr.data.end(), vals.begin(), vals.end());
    } else if (tok_is(tok, tl, "DATA_FEATURE_POINTXY")) {
      // tag dim x y i11 i12 i22
      if (read_n(7, vals)) {
        ft.data.push_back(last_vertex);
        for (int k = 2; k < 7; k++) ft.data.push_back(vals[k]);
      }
    } else if (tok_is(tok, tl, "LASER_ROBOT_DATA")) {
      // paramIdx firstAngle fov res maxRange accuracy remissionMode N ...
      if (read_n(8, vals)) {
        long n = (long)vals[7];
        long off = (long)lr.data.size();
        std::vector<double> rg;
        if (read_n(n, rg)) {
          lr.data.insert(lr.data.end(), rg.begin(), rg.end());
          lm.data.push_back(last_vertex);
          lm.data.push_back(vals[0]);
          lm.data.push_back(vals[1]);
          lm.data.push_back(vals[2]);
          lm.data.push_back(vals[3]);
          lm.data.push_back(vals[4]);
          lm.data.push_back(vals[5]);
          lm.data.push_back((double)off);
          lm.data.push_back((double)n);
        }
      }
      skip_line();  // remissions etc. ignored (parity: optional payload)
    } else {
      skip_line();
    }
  }

  G2OResult* r = (G2OResult*)calloc(1, sizeof(G2OResult));
  fill(r->vertex_se2, v2);
  fill(r->vertex_xy, vxy);
  fill(r->vertex_se3, v3);
  fill(r->edge_se2, e2);
  fill(r->edge_se2_xy, exy);
  fill(r->edge_se3, e3);
  fill(r->fixed, fx);
  fill(r->params, pr);
  fill(r->features, ft);
  fill(r->laser_meta, lm);
  fill(r->laser_ranges, lr);
  fill(r->vertex_line2d, vl);
  fill(r->vertex_extreme, vx);
  fill(r->edge_se2_line2d, esl);
  fill(r->edge_line2d_xy, elx);
  return r;
}

void fastg2o_free(G2OResult* r) {
  if (!r) return;
  CTable* ts = (CTable*)r;
  for (int i = 0; i < 15; i++)
    if (ts[i].data) free(ts[i].data);
  free(r);
}

}  // extern "C"
