"""Synthesis entry point: text + style prompt + voice prompt -> waveform —
counterpart of ``mamba_tts_tpu/infer/synthesize.py``.

    text --G2P--> phonemes --TextEncoder--> text_hidden
    style prompt --BERT--> SMSD sample --> z_style
    voice prompt --FACodec encode--> ref tokens --embed--> ref_hidden
    duration predictor --> frame budget (64-frame buckets)
    autoregressive decode over Q * frames tokens (plain or int8 step)
    codec ids --FACodec decode--> waveform

``quant`` selects the decode: "none" (full-precision step), "int8" (the
large per-step products through the Hopper ``int8_matvec`` kernel) or
"int8_kv" (int8 weights and int8 cross-attention K/V).  "megakernel" and
mesh-parallel serving are the next slices of the port and raise
``NotImplementedError``.

Runs on the CUDA card unless ``device="cpu"`` is passed; with no card it
raises rather than falling back.

CLI:
    python -m mamba_tts_torch.infer.synthesize --text "hello world" \\
        --style_prompt "speak fast" --voice_wav prompt.wav --output out.wav \\
        [--quant int8] [--device cuda]
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Tuple

import numpy as np
import torch

from mamba_tts_torch.audio.codec import FACodecTokenizer
from mamba_tts_torch.config import TTSConfig
from mamba_tts_torch.device import resolve_device
from mamba_tts_torch.infer.quant_decode import greedy_decode_int8, quantize_decoder_params
from mamba_tts_torch.models.decoder import greedy_decode
from mamba_tts_torch.models.layers import seed_init
from mamba_tts_torch.models.style_text_encoder import StyleTextEncoder
from mamba_tts_torch.models.tts import MambaTTS
from mamba_tts_torch.text.processor import PhonemeFrontend

_MEGAKERNEL_TODO = (
    "quant='megakernel' is the next slice of the port: the one-launch decode "
    "kernel mamba_tts_tpu/ops/decode_megakernel.py:532 has no Hopper kernel yet "
    "(PERF.md kernel table row 5, ROADMAP queue 1 item 7 and queue 2); use "
    "quant='int8' or 'int8_kv'")
_MESH_TODO = (
    "mesh-parallel serving (mesh= / --dp_serving) is not ported yet "
    "(ROADMAP queue 1, parallelism item)")


class Synthesizer:
    """End-to-end TTS inference engine over a :class:`MambaTTS` module."""

    def __init__(
        self,
        cfg: TTSConfig,
        model: MambaTTS,
        tokenizer: Optional[FACodecTokenizer] = None,
        frontend: Optional[PhonemeFrontend] = None,
        style_encoder: Optional[StyleTextEncoder] = None,
        quant: str = "none",
        mesh=None,
        device="cuda",
    ):
        if quant == "megakernel":
            raise NotImplementedError(_MEGAKERNEL_TODO)
        if quant not in ("none", "int8", "int8_kv"):
            raise ValueError(f"quant must be none|int8|int8_kv, got {quant!r}")
        if mesh is not None:
            raise NotImplementedError(_MESH_TODO)
        self.cfg = cfg
        self.quant = quant
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.decoder = self.model.decoder
        self._qparams = quantize_decoder_params(self.decoder) if quant != "none" else None
        self.tokenizer = tokenizer or FACodecTokenizer(cfg.codec, device=self.device)
        self.frontend = frontend or PhonemeFrontend(vocab_path=cfg.data.phoneme_vocab_path)
        self.style_encoder = style_encoder or StyleTextEncoder(cfg.style_encoder, device=self.device)
        self._voice_cache = {}  # name -> (codec (max_seq, Q), true frames)

    # ------------------------------------------------------------- pipeline

    def _tensors(self, phoneme_ids, text_mask, voice_codec):
        dev = self.device
        return (torch.as_tensor(phoneme_ids, dtype=torch.long, device=dev),
                torch.as_tensor(text_mask, dtype=torch.bool, device=dev),
                torch.as_tensor(voice_codec, dtype=torch.long, device=dev))

    @torch.no_grad()
    def decode_tokens(self, phoneme_ids, text_mask, style_bert, voice_codec, frames: int,
                      temperature: float = 0.0,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Condition and decode rows at one frame budget; (B, Q*frames)
        token ids on the device.  ``generator`` draws the style sample and,
        when ``temperature > 0``, the tokens."""
        model = self.model
        text_hidden = model.encode_text(phoneme_ids, text_mask)
        z_style = model.sample_style(style_bert, generator)
        ref_hidden, ref_mask = model.embed_voice(voice_codec)
        kw = dict(text_mask=text_mask, ref_hidden=ref_hidden, ref_mask=ref_mask,
                  temperature=temperature, generator=generator)
        if self.quant == "none":
            res = greedy_decode(self.decoder, text_hidden, z_style, frames, **kw)
        else:
            res = greedy_decode_int8(self.decoder, self._qparams, text_hidden, z_style, frames,
                                     int8_kv=self.quant == "int8_kv", **kw)
        return res.tokens

    def register_voice(self, name: str, voice_wav) -> None:
        """Encode a voice prompt once and cache its codec grid under
        ``name``; ``synthesize``/``synthesize_batch`` then accept the name in
        place of the waveform and skip the FACodec encode."""
        codec, _, lens = self.tokenizer.encode_with_lengths([voice_wav])
        self._voice_cache[name] = (np.asarray(codec[0]), int(lens[0]))

    def _encode_voice(self, voice_wavs) -> np.ndarray:
        """Tokenize voice prompts (waveforms, paths or registered names) and
        trim the codec grid to a 64-frame bucket of the longest true prompt.
        Identical waveform objects (and equal paths) encode once."""
        rows: list = [None] * len(voice_wavs)
        lens: list = [0] * len(voice_wavs)
        fresh, fresh_idx, seen = [], [], {}
        for i, v in enumerate(voice_wavs):
            if isinstance(v, str) and v in self._voice_cache:
                rows[i], lens[i] = self._voice_cache[v]
                continue
            key = v if isinstance(v, str) else id(v)
            if key in seen:
                rows[i] = seen[key]  # backreference, filled after encode
            else:
                seen[key] = i
                fresh.append(v)
                fresh_idx.append(i)
        if fresh:
            codec, _, fresh_lens = self.tokenizer.encode_with_lengths(fresh)
            for j, i in enumerate(fresh_idx):
                rows[i] = np.asarray(codec[j])
                lens[i] = int(fresh_lens[j])
        for i, r in enumerate(rows):
            if isinstance(r, int):
                rows[i], lens[i] = rows[r], lens[r]
        S = int(min(self.cfg.codec.max_seq_len, -(-max(8, max(lens)) // 64) * 64))
        return np.stack([r[:S] for r in rows])

    @torch.no_grad()
    def predict_frames_per_utterance(self, phoneme_ids, text_mask) -> np.ndarray:
        """(B,) frame budgets: sum of exp(log_dur) over valid phonemes."""
        ids = torch.as_tensor(phoneme_ids, dtype=torch.long, device=self.device)
        mask = torch.as_tensor(text_mask, dtype=torch.bool, device=self.device)
        log_dur = self.model.predict_durations(self.model.encode_text(ids, mask), mask)
        frames = (torch.exp(log_dur) * mask.to(log_dur.dtype)).sum(dim=1).cpu().numpy()
        return np.clip(frames, 8, self.cfg.codec.max_seq_len).astype(np.int64)

    def predict_frames(self, phoneme_ids, text_mask) -> int:
        return int(self.predict_frames_per_utterance(phoneme_ids, text_mask).max())

    def _bucket(self, frames) -> int:
        return int(min(-(-int(frames) // 64) * 64, self.cfg.codec.max_seq_len))

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _decode_rows(self, arrays, frames: int, temperature: float, generator) -> np.ndarray:
        """Decode rows at one frame budget; (B, Q*frames) tokens on the host."""
        tokens = self.decode_tokens(*arrays, frames, temperature, generator)
        return tokens.cpu().numpy()

    def synthesize(self, text: str, style_prompt: str, voice_wav, frames: Optional[int] = None,
                   temperature: float = 0.0, seed: int = 0) -> Tuple[np.ndarray, dict]:
        """Returns (waveform (T,) float32 at 16 kHz, info).  ``voice_wav`` is
        a waveform array, a WAV path or a :meth:`register_voice` name."""
        t0 = time.perf_counter()
        phoneme_ids, _, text_mask = self.frontend.encode_batch(
            [text], pad_to=self.cfg.data.max_text_len)
        style_bert = self.style_encoder.embed([style_prompt])
        voice_codec = self._encode_voice([voice_wav])
        if frames is None:
            frames = self.predict_frames(phoneme_ids, text_mask)
        frames = self._bucket(frames)
        ids, mask, voice = self._tensors(phoneme_ids, text_mask, voice_codec)
        tokens = self._decode_rows((ids, mask, style_bert, voice), frames, temperature,
                                   self._generator(seed))
        Q = self.cfg.decoder.num_quantizers
        codec = tokens.reshape(1, Q, frames).transpose(0, 2, 1)
        wav = self.tokenizer.decode(codec)[0]
        wall = time.perf_counter() - t0
        audio_seconds = frames / self.tokenizer.frames_per_second
        info = {
            "frames": frames,
            "tokens": int(Q * frames),
            "audio_seconds": audio_seconds,
            "wall_seconds": wall,
            "rtf": wall / audio_seconds,
        }
        return wav, info

    def synthesize_batch(self, texts, style_prompts, voice_wavs, frames: Optional[int] = None,
                         temperature: float = 0.0, seed: int = 0,
                         variable_length: bool = False):
        """Batched serving: lists of (text, style, voice prompt).

        ``variable_length=False``: every row decodes at the batch-max frame
        bucket; returns (B, T_audio) stacked waveforms.  ``True``: rows group
        by their own 64-frame duration bucket and each group decodes at its
        own budget; returns a list of waveforms trimmed to their predicted
        frames (capped at ``frames`` when given, which then fixes one
        bucket)."""
        if not len(texts) == len(style_prompts) == len(voice_wavs):
            raise ValueError("texts, style_prompts and voice_wavs differ in length")
        t0 = time.perf_counter()
        phoneme_ids, _, text_mask = self.frontend.encode_batch(
            list(texts), pad_to=self.cfg.data.max_text_len)
        style_bert = self.style_encoder.embed(list(style_prompts))
        voice_codec = self._encode_voice(list(voice_wavs))
        B = len(texts)
        Q = self.cfg.decoder.num_quantizers
        ids, mask, voice = self._tensors(phoneme_ids, text_mask, voice_codec)
        arrays = (ids, mask, style_bert, voice)
        generator = self._generator(seed)

        if variable_length:
            per_utt = self.predict_frames_per_utterance(phoneme_ids, text_mask)
            if frames is not None:
                per_utt = np.minimum(per_utt, int(frames))
                buckets = np.full(B, self._bucket(frames))
            else:
                buckets = np.array([self._bucket(f) for f in per_utt])
            wavs: list = [None] * B
            total_tokens = 0
            for bucket in sorted(set(buckets.tolist())):
                idx = np.nonzero(buckets == bucket)[0]
                sel = torch.as_tensor(idx, device=self.device)
                tokens = self._decode_rows(tuple(a[sel] for a in arrays), bucket, temperature,
                                           generator)
                codec = tokens.reshape(len(idx), Q, bucket).transpose(0, 2, 1)
                group_wavs = self.tokenizer.decode(codec)
                for row, i in enumerate(idx):
                    wavs[int(i)] = group_wavs[row][: int(per_utt[i]) * self.tokenizer.hop]
                total_tokens += len(idx) * Q * bucket
            wall = time.perf_counter() - t0
            info = {
                "frames": [int(f) for f in per_utt],
                "buckets": buckets.tolist(),
                "tokens": total_tokens,
                "audio_seconds": [int(f) / self.tokenizer.frames_per_second for f in per_utt],
                "wall_seconds": wall,
                "tokens_per_sec": total_tokens / wall,
            }
            return wavs, info

        if frames is None:
            frames = self.predict_frames(phoneme_ids, text_mask)
        frames = self._bucket(frames)
        tokens = self._decode_rows(arrays, frames, temperature, generator)
        codec = tokens.reshape(B, Q, frames).transpose(0, 2, 1)
        wavs = self.tokenizer.decode(codec)
        wall = time.perf_counter() - t0
        info = {
            "frames": frames,
            "tokens": int(B * Q * frames),
            "audio_seconds": frames / self.tokenizer.frames_per_second,
            "wall_seconds": wall,
            "tokens_per_sec": B * Q * frames / wall,
        }
        return wavs, info


def load_synthesizer(cfg: Optional[TTSConfig] = None, checkpoint_dir: Optional[str] = None,
                     seed: int = 0, codec_ckpts=None, quant: str = "none", mesh=None,
                     device="cuda") -> Synthesizer:
    """A :class:`Synthesizer` at a seeded random init (the model from
    ``seed``; FACodec and BERT from seed 0, as in the JAX package).
    Checkpoint loading is not ported yet and raises."""
    if checkpoint_dir is not None or codec_ckpts:
        raise NotImplementedError(
            "checkpoint loading (orbax trees, FACodec and BERT checkpoints) is not "
            "ported yet (ROADMAP queue 1); load_synthesizer builds seeded random "
            "weights only")
    if quant == "megakernel":
        raise NotImplementedError(_MEGAKERNEL_TODO)
    if mesh is not None:
        raise NotImplementedError(_MESH_TODO)
    cfg = cfg or TTSConfig()
    dev = resolve_device(device)
    model = seed_init(MambaTTS(cfg), seed)
    return Synthesizer(cfg, model, quant=quant, device=dev)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--text", type=str, default=None,
                        help="single-utterance mode (or use --texts_file)")
    parser.add_argument("--style_prompt", type=str, default="speak in a neutral voice")
    parser.add_argument("--voice_wav", type=str, required=True)
    parser.add_argument("--output", type=str, default="synthesized.wav")
    parser.add_argument("--checkpoint_dir", type=str, default=None)
    parser.add_argument("--config_json", type=str, default=None)
    parser.add_argument("--frames", type=int, default=None)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--facodec_encoder_ckpt", type=str, default=None)
    parser.add_argument("--facodec_decoder_ckpt", type=str, default=None)
    parser.add_argument("--quant", type=str, default="none",
                        choices=("none", "int8", "int8_kv", "megakernel"),
                        help="decode numerics (int8 weight streaming through the "
                             "Hopper int8_matvec kernel; int8_kv also int8 K/V; "
                             "megakernel is not ported yet and raises)")
    parser.add_argument("--texts_file", type=str, default=None,
                        help="batch mode: one text per line (style/voice prompts "
                             "shared); writes <output-stem>_NNN.wav per line")
    parser.add_argument("--variable_length", action="store_true",
                        help="batch mode: group rows by their own 64-frame bucket")
    parser.add_argument("--dp_serving", action="store_true",
                        help="mesh-parallel serving (not ported yet; raises)")
    parser.add_argument("--bert_vocab", type=str, default=None,
                        help="path to a real BERT vocab.txt for the style-text encoder")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                        help="run on the CUDA card (default) or the CPU")
    args = parser.parse_args(argv)
    if args.text is None and not args.texts_file:
        parser.error("one of --text or --texts_file is required")
    if args.dp_serving:
        raise NotImplementedError(_MESH_TODO)

    from mamba_tts_torch import config as config_lib
    from mamba_tts_torch.audio.wavio import write_wav

    cfg = (config_lib.from_json(open(args.config_json).read())
           if args.config_json else TTSConfig())
    if args.bert_vocab:
        cfg = config_lib.override(cfg, "style_encoder.bert_vocab", args.bert_vocab)
    ckpts = ((args.facodec_encoder_ckpt, args.facodec_decoder_ckpt)
             if args.facodec_encoder_ckpt else None)
    synth = load_synthesizer(cfg, args.checkpoint_dir, args.seed, codec_ckpts=ckpts,
                             quant=args.quant, device=args.device)
    if args.texts_file:
        texts = [ln.strip() for ln in open(args.texts_file) if ln.strip()]
        B = len(texts)
        wavs, info = synth.synthesize_batch(
            texts, [args.style_prompt] * B, [args.voice_wav] * B, frames=args.frames,
            temperature=args.temperature, seed=args.seed, variable_length=args.variable_length)
        stem = args.output[:-4] if args.output.endswith(".wav") else args.output
        for i, w in enumerate(wavs):
            write_wav(f"{stem}_{i:03d}.wav", np.asarray(w), cfg.codec.sample_rate)
        print(info)
        print(f"wrote {B} wavs to {stem}_*.wav")
        return
    wav, info = synth.synthesize(args.text, args.style_prompt, args.voice_wav,
                                 frames=args.frames, temperature=args.temperature,
                                 seed=args.seed)
    write_wav(args.output, wav, cfg.codec.sample_rate)
    print(info)
    print(f"wrote {args.output}: {info['audio_seconds']:.2f}s audio, RTF {info['rtf']:.3f}")


if __name__ == "__main__":
    main()
