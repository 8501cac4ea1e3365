"""Generate golden fixtures by EXECUTING GATB's superkmerization.

The reference's shuffle-map stage is GATB's Sequence2SuperKmer with
SuperKmer::save's 2-bit packing (Model.hpp:1388-1433) — driven by
ModelMinimizer<ModelCanonical> in the actual binary (the
fill_partitions.hpp:20 NONCANONICAL define is dead by include order;
see tests/test_ref_exec_golden.py SCHEMES). No
reference-generated superkmer fixture exists in its tree, so this script
builds gatb-core-stripped (cmake/ninja, out-of-source) and runs a driver
that mirrors KmFillPartitions::processSuperkmer's save path, capturing
for every input sequence the exact (minimizer, #kmers, packed bytes)
stream — plus a per-k-mer (valid, minimizer) dump of the rolling model.

Run from the repo root (needs /root/reference + g++ + cmake + ninja):

    python scripts/gen_gatb_golden.py

Fixtures (committed):
  superk_golden.tsv   k, m, seq, then per-superkmer "minim,nkmers,hex"
  minim_roll_golden.tsv  k, m, seq, per-kmer "v:minim" of the rolling
                      NONCANONICAL minimizer model (invalid bases cut)
"""

import os
import random
import subprocess
import sys
import tempfile

REF = "/root/reference/thirdparty/gatb-core-stripped"
HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "..", "tests", "data_ref_exec")
BUILD = os.environ.get("KMTRICKS_GATB_BUILD", os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".bench",
    "gatb_build"))

# compiled twice: plain (ModelCanonical — the reference BINARY's actual
# routing: fill_partitions.hpp:20's NONCANONICAL define is dead by include
# order, see tests/test_ref_exec_golden.py SCHEMES) and -DNONCANONICAL
# (ModelDirect — the dead define's intent, our --mmer-scheme forward)
DRIVER = r"""
#include <gatb/gatb_core.hpp>
#include <gatb/kmer/impl/Sequence2SuperKmer.hpp>
#include <cstdio>
#include <iostream>
#include <sstream>
#include <string>
#include <vector>

using namespace gatb::core;
using namespace gatb::core::kmer;
using namespace gatb::core::kmer::impl;

struct Sink {
  std::string out;
  unsigned long long cur_minim = 0;
  void insertSuperkmer(const u_int8_t* buf, size_t nbytes, size_t nkmers,
                       int) {
    char head[64];
    snprintf(head, sizeof(head), "%llu,%zu,", cur_minim, nkmers);
    out += head;
    char h[4];
    for (size_t i = 0; i < nbytes; i++) {
      snprintf(h, sizeof(h), "%02x", buf[i]);
      out += h;
    }
    out += " ";
  }
};

template<size_t span>
struct Collector : public Sequence2SuperKmer<span> {
  typedef Sequence2SuperKmer<span> Base;
  typedef typename Base::Model Model;
  typedef typename Base::SuperKmer SuperKmer;
  Sink* sink;
  Collector(Model& model, tools::dp::IteratorListener* prog,
            BankStats& bs, Sink* s)
    : Base(model, 1, 0, 1, prog, bs), sink(s) {}
  void processSuperkmer(SuperKmer& sk) override {
    if (sk.isValid() && sk.size() > 0) {
      sink->cur_minim = sk.minimizer;
      sk.save(0, sink);
    }
  }
};

template<size_t span>
void superk(int k, int m, const std::string& s) {
  typedef typename Collector<span>::Model Model;
  Model model(k, m);
  BankStats bs;
  Sink sink;
  Collector<span> coll(model, nullptr, bs, &sink);
  bank::Sequence seq;
  seq.getData().setRef(const_cast<char*>(s.data()), s.size());
  coll(seq);
  std::printf("%d\t%d\t%s\t%s\n", k, m, s.c_str(), sink.out.c_str());
}

template<size_t span>
void minim_roll(int k, int m, const std::string& s) {
#ifdef NONCANONICAL
  typedef typename Kmer<span>::template ModelMinimizer<
      typename Kmer<span>::ModelDirect> Model;
#else
  typedef typename Kmer<span>::template ModelMinimizer<
      typename Kmer<span>::ModelCanonical> Model;
#endif
  Model model(k, m);
  std::printf("%d\t%d\t%s\t", k, m, s.c_str());
  tools::misc::Data data(tools::misc::Data::ASCII);   // default is BINARY
  data.setRef(const_cast<char*>(s.data()), s.size());
  model.iterate(data, [&](const typename Model::Kmer& kmer, size_t) {
    std::printf("%d:%llu ", kmer.isValid() ? 1 : 0,
                kmer.isValid()
                    ? (unsigned long long)kmer.minimizer().value().getVal()
                    : 0ULL);
  });
  std::printf("\n");
}

int main(int argc, char** argv) {
  bool do_superk = std::string(argv[1]) == "superk";
  std::string line;
  while (std::getline(std::cin, line)) {
    std::istringstream iss(line);
    int m; std::string seq;
    iss >> m >> seq;
    size_t k_sz;
    iss >> k_sz;                 // explicit k (may be < seq length)
    int k = (int)k_sz;
    // smallest span STRICTLY greater than k (loop_executor.hpp:23-70 —
    // a span-32 model supports k <= 31)
    if (k < 32) do_superk ? superk<32>(k, m, seq)
                          : minim_roll<32>(k, m, seq);
    else if (k < 64) do_superk ? superk<64>(k, m, seq)
                               : minim_roll<64>(k, m, seq);
    else if (k < 96) do_superk ? superk<96>(k, m, seq)
                               : minim_roll<96>(k, m, seq);
    else do_superk ? superk<128>(k, m, seq) : minim_roll<128>(k, m, seq);
  }
  return 0;
}
"""


def ensure_gatb() -> str:
    lib = os.path.join(BUILD, "lib", "Release", "libgatbcore.a")
    if not os.path.exists(lib):
        os.makedirs(BUILD, exist_ok=True)
        subprocess.run(["cmake", REF, "-DCMAKE_BUILD_TYPE=Release",
                        "-G", "Ninja"], cwd=BUILD, check=True,
                       capture_output=True)
        subprocess.run(["ninja", "gatbcore-static"], cwd=BUILD, check=True,
                       capture_output=True)
    return lib


def main() -> None:
    os.makedirs(OUT, exist_ok=True)
    lib = ensure_gatb()
    tmp = tempfile.mkdtemp()
    exes = {}
    for variant, flags in (("noncanon", ["-DNONCANONICAL"]),
                           ("canon", [])):
        exe = os.path.join(tmp, f"gatb_golden_{variant}")
        src = exe + ".cpp"
        with open(src, "w") as f:
            f.write(DRIVER)
        subprocess.run(
            ["g++", "-O2", "-std=c++17", *flags, f"-I{REF}/src",
             f"-I{BUILD}/include", f"-I{REF}/thirdparty",
             src, lib, "-o", exe, "-lz", "-lpthread", "-ldl"],
            check=True)
        exes[variant] = exe

    rng = random.Random(20260818)
    cases = []
    for k in (15, 20, 31, 32, 33, 45, 63, 64, 65, 96, 127):
        for m in (8, 10):
            for _ in range(12):
                L = rng.choice([k, k + 1, k + 7, 3 * k, 150, 260])
                seq = "".join(rng.choice("ACGT") for _ in range(L))
                cases.append((m, seq, k))
            # invalid bases cut superkmers / windows
            for _ in range(6):
                L = max(3 * k, 150)
                seq = list("".join(rng.choice("ACGT") for _ in range(L)))
                for _ in range(rng.randint(1, 6)):
                    seq[rng.randrange(L)] = "N"
                cases.append((m, "".join(seq), k))
            # homopolymer: every m-mer forbidden -> sentinel minimizers
            cases.append((m, "A" * (2 * k), k))
            # long run sharing one minimizer: exercises the maxs cap
            cases.append((m, "C" * 300, k))
    stdin = "".join(f"{m} {s} {k}\n" for m, s, k in cases)
    for variant, exe in exes.items():
        for mode, name in (("superk", f"superk_golden_{variant}.tsv"),
                           ("minim", f"minim_roll_golden_{variant}.tsv")):
            got = subprocess.run([exe, mode], input=stdin,
                                 capture_output=True, text=True,
                                 check=True).stdout
            with open(os.path.join(OUT, name), "w") as f:
                f.write(got)
            print(f"{name}: {len(got.splitlines())} rows")


if __name__ == "__main__":
    main()
