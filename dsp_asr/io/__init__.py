"""Host-side I/O: WAV decode, synthetic corpora, dataset layout, recording."""

from dsp_asr.io.wav import read_wav, write_wav
from dsp_asr.io.dataset import synth_word, make_corpus, load_corpus_dir

__all__ = ["read_wav", "write_wav", "synth_word", "make_corpus", "load_corpus_dir"]

from dsp_asr.io.record import record, record_fake  # noqa: E402

__all__ += ["record", "record_fake"]
