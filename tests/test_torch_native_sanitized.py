"""The port's native iterator and engine (mxnet_tpu_torch/csrc/native/)
under the compiler's sanitizers.

A C++ program built with the sources, once with
-fsanitize=address,undefined and once with -fsanitize=thread, resets an
ImageRecordIter with 8 decode workers mid-epoch 200 times (each full
epoch after a reset must give the first epoch's bits) and destroys it
mid-epoch, and runs a dependency program on the engine. The test passes
only if the program finishes and the sanitizers report nothing: the JAX
copy of the iterator freed its in-flight batches at a reset while a
worker could still decode into one.
"""
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip('cv2')

from mxnet_tpu_torch import _build
from mxnet_tpu_torch import recordio as rec

PROGRAM = r'''
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <string>
#include <vector>

#include "engine.h"
#include "image_record_iter.h"

using mxt_native::engine::ThreadedEngine;
using mxt_native::io::ImageRecordIter;
using mxt_native::io::ImageRecordParam;

static std::vector<std::vector<float>> Epoch(ImageRecordIter* it,
                                             size_t n) {
  std::vector<std::vector<float>> out;
  while (it->Next()) {
    out.emplace_back(it->data(), it->data() + n);
    out.back().push_back(static_cast<float>(it->pad()));
  }
  return out;
}

int main(int argc, char** argv) {
  ImageRecordParam p;
  p.path_imgrec = std::string(argv[1]) + ".rec";
  p.path_imgidx = std::string(argv[1]) + ".idx";
  p.batch_size = 3;
  p.height = p.width = 16;
  p.num_threads = 8;
  p.prefetch = 2;
  const int resets = std::atoi(argv[2]);
  std::mt19937 rng(7);
  {
    ImageRecordIter it(p);
    const size_t n = it.data_size();
    auto first = Epoch(&it, n);
    for (int r = 0; r < resets; ++r) {
      it.Reset();
      int k = static_cast<int>(rng() % first.size());
      for (int i = 0; i < k && it.Next(); ++i) {
      }
      it.Reset();
      if (Epoch(&it, n) != first) {
        std::printf("epoch after reset %d differs\n", r);
        return 1;
      }
    }
    it.Reset();
    it.Next();  // destroyed mid-epoch, workers busy
  }
  {
    ThreadedEngine eng(8);
    std::vector<int64_t> vars;
    for (int i = 0; i < 16; ++i) vars.push_back(eng.NewVariable());
    std::vector<unsigned long long> state(16, 1);
    for (int i = 0; i < 4000; ++i) {
      int a = rng() % 16, b = rng() % 16;
      if (a == b) {
        eng.Push([&state, a] { state[a] += 1; }, {}, {vars[a]});
      } else {
        eng.Push([&state, a, b] { state[b] = state[b] * 3 + state[a]; },
                 {vars[a]}, {vars[b]});
      }
      if (i % 500 == 0) eng.WaitForVar(vars[a]);
    }
    eng.WaitForAll();
    for (int i = 0; i < 16; i += 2) eng.DeleteVariable(vars[i]);
    eng.WaitForAll();
  }
  std::printf("SANITIZED OK\n");
  return 0;
}
'''

SOURCES = ('engine.cc', 'recordio.cc', 'image_record_iter.cc')


def _records(tmp_path, n=23):
    prefix = str(tmp_path / 'imgs')
    w = rec.MXIndexedRecordIO(prefix + '.idx', prefix + '.rec', 'w')
    rs = np.random.RandomState(0)
    for i in range(n):
        h, wd = rs.randint(18, 60, 2)
        ok, buf = cv2.imencode('.jpg', rs.randint(0, 255, (h, wd, 3))
                               .astype(np.uint8))
        assert ok
        w.write_idx(i, rec.pack(rec.IRHeader(0, float(i), i, 0),
                                buf.tobytes()))
    w.close()
    return prefix


@pytest.mark.parametrize('sanitizer', ['address,undefined', 'thread'])
def test_iterator_resets_and_engine_under_sanitizers(tmp_path, sanitizer):
    if not shutil.which('g++'):
        pytest.skip('no g++')
    src = tmp_path / 'reset_stress.cc'
    src.write_text(PROGRAM)
    cflags, libs = _build.opencv_flags()
    native = Path(_build.__file__).parent / 'csrc' / 'native'
    exe = str(tmp_path / 'reset_stress')
    cmd = ['g++', '-O1', '-g', '-std=c++17', '-pthread',
           '-fno-omit-frame-pointer', '-fsanitize=' + sanitizer,
           '-I' + str(native), *cflags, str(src),
           *[str(native / s) for s in SOURCES], '-o', exe, *libs]
    build = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=600)
    assert build.returncode == 0, build.stderr[-3000:]
    prefix = _records(tmp_path)
    # GDAL, which OpenCV's imgcodecs links, takes two of its own mutexes
    # in both orders while it registers its formats: a report inside that
    # uninstrumented library, not about the code under test
    supp = tmp_path / 'tsan.supp'
    supp.write_text('deadlock:libgdal.so\n')
    env = {'ASAN_OPTIONS': 'detect_leaks=1:halt_on_error=1',
           'UBSAN_OPTIONS': 'print_stacktrace=1:halt_on_error=1',
           'TSAN_OPTIONS': 'halt_on_error=1:second_deadlock_stack=1:'
                           'suppressions=%s' % supp}
    proc = subprocess.run([exe, prefix, '200'], capture_output=True,
                          text=True, timeout=900, env=env)
    report = proc.stderr
    assert proc.returncode == 0, report[-6000:]
    assert 'SANITIZED OK' in proc.stdout, (proc.stdout, report[-3000:])
    for word in ('AddressSanitizer', 'ThreadSanitizer', 'runtime error',
                 'LeakSanitizer'):
        assert word not in report, report[-6000:]
