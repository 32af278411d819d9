"""Sound engine (counterpart of clap_tpu/utils/sound.py;
reference: core/sound.{c,h} — miniaudio + kissfft:
per-sound gain/loop, effect chains, ogg/vorbis assets).

Audio is host-rim I/O (the reference runs miniaudio on the CPU thread);
this module provides the same capabilities without native deps:

- WAV loading (stdlib) + procedural synthesis (test content — the
  reference's ogg assets aren't in-tree, SURVEY §6)
- a fixed-voice mixer with per-voice gain/loop/pitch (sound.c gain/loop)
- FFT-based effect chain (low-pass / reverb-ish), the kissfft analogue,
  runnable through numpy or jnp.fft on device
"""
from __future__ import annotations

import wave
from dataclasses import dataclass, field

import numpy as np

SAMPLE_RATE = 44100
MAX_VOICES = 16


def load_wav(path) -> np.ndarray:
    with wave.open(str(path), "rb") as w:
        n = w.getnframes()
        raw = w.readframes(n)
        dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[w.getsampwidth()]
        data = np.frombuffer(raw, dtype).astype(np.float32)
        if w.getsampwidth() == 1:
            data = (data - 128.0) / 128.0
        else:
            data = data / float(np.iinfo(dtype).max)
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels()).mean(-1)
    return data


def load_ogg(path_or_bytes) -> np.ndarray:
    """Decode an ogg/vorbis asset to mono float32 (the reference's
    primary sound-asset format, sound.c via stb_vorbis; here bound to
    the system libvorbisfile — utils/ogg.py)."""
    from .ogg import decode_ogg, decode_ogg_bytes

    if isinstance(path_or_bytes, (bytes, bytearray)):
        pcm, _rate = decode_ogg_bytes(bytes(path_or_bytes))
    else:
        pcm, _rate = decode_ogg(str(path_or_bytes))
    return pcm.mean(-1) if pcm.ndim > 1 else pcm


def load_sound(path) -> np.ndarray:
    """Format-dispatching loader (librarian hands sound.c whatever the
    scene references: .ogg or .wav)."""
    p = str(path)
    if p.endswith(".ogg"):
        return load_ogg(p)
    return load_wav(p)


def save_wav(path, data: np.ndarray, rate: int = SAMPLE_RATE) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(data, -1, 1) * 32767).astype(np.int16).tobytes())


def synth_tone(freq: float, seconds: float, rate: int = SAMPLE_RATE,
               envelope: bool = True) -> np.ndarray:
    t = np.arange(int(seconds * rate)) / rate
    s = np.sin(2 * np.pi * freq * t).astype(np.float32)
    if envelope:
        s *= np.exp(-3.0 * t).astype(np.float32)
    return s


@dataclass
class Voice:
    sound: int = -1
    pos: float = 0.0
    gain: float = 1.0
    pitch: float = 1.0
    loop: bool = False
    playing: bool = False


@dataclass
class SoundEngine:
    """sound_init/sound_play/... (sound.h API shape)."""

    rate: int = SAMPLE_RATE
    sounds: list = field(default_factory=list)
    voices: list = field(default_factory=lambda: [Voice() for _ in range(MAX_VOICES)])
    master_gain: float = 1.0
    chains: dict = field(default_factory=dict)   # sound id → effect list
    master_chain: list = field(default_factory=list)

    def add_sound(self, data: np.ndarray) -> int:
        self.sounds.append(np.asarray(data, np.float32))
        return len(self.sounds) - 1

    def set_effect_chain(self, sound: int, chain) -> None:
        """Attach (or None = detach) an effect chain to a SOUND — every
        voice playing it renders through the chain
        (sound_set_effect_chain, sound.h:45-49)."""
        if chain is None:
            self.chains.pop(sound, None)
        else:
            self.chains[sound] = list(chain)

    def play(self, sound: int, gain: float = 1.0, loop: bool = False,
             pitch: float = 1.0) -> int:
        for vi, v in enumerate(self.voices):
            if not v.playing:
                self.voices[vi] = Voice(sound=sound, pos=0.0, gain=gain,
                                        pitch=pitch, loop=loop, playing=True)
                return vi
        return -1

    def stop(self, voice: int) -> None:
        if 0 <= voice < MAX_VOICES:
            self.voices[voice].playing = False

    def set_gain(self, voice: int, gain: float) -> None:
        self.voices[voice].gain = gain

    def mix(self, frames: int) -> np.ndarray:
        """Advance all voices and mix ``frames`` samples."""
        out = np.zeros(frames, np.float32)
        for v in self.voices:
            if not v.playing or v.sound < 0:
                continue
            data = self.sounds[v.sound]
            idx = v.pos + np.arange(frames) * v.pitch
            if v.loop:
                idx = np.mod(idx, len(data))
                seg = data[idx.astype(np.int64)]
                v.pos = float(np.mod(v.pos + frames * v.pitch, len(data)))
            else:
                valid = idx < len(data)
                seg = np.where(valid, data[np.minimum(idx, len(data) - 1)
                                           .astype(np.int64)], 0.0)
                v.pos += frames * v.pitch
                if v.pos >= len(data):
                    v.playing = False
            seg = seg * v.gain
            chain = self.chains.get(v.sound)
            if chain:
                seg = apply_effect_chain(chain, seg.astype(np.float32))
            out += seg
        out = out * self.master_gain
        if self.master_chain:
            out = apply_effect_chain(self.master_chain, out)
        return np.clip(out, -1.0, 1.0)


def lowpass_fft(signal: np.ndarray, cutoff_hz: float,
                rate: int = SAMPLE_RATE) -> np.ndarray:
    """FFT brick-wall low-pass — the kissfft effect-chain analogue
    (runs equally via jnp.fft on device for batched buffers)."""
    spec = np.fft.rfft(signal)
    freqs = np.fft.rfftfreq(len(signal), 1.0 / rate)
    spec = np.where(freqs <= cutoff_hz, spec, 0.0)
    return np.fft.irfft(spec, len(signal)).astype(np.float32)


# ---------------------------------------------------------------------------
# Effect chains (sound.c:302-630: reverb + delay audio post processing,
# attached per sound / per chain; EQ and compressor are empty descriptor
# slots in the reference too, sound.c:619-620)
# ---------------------------------------------------------------------------

_REVERB_TYPES = {
    # comb delay sizes, allpass delay sizes (sound.c:342-357)
    "small_room": ([1200, 1433, 1597, 1759], [149, 211]),
    "hall": ([1723, 1999, 2239, 2503, 2801, 3203], [173, 263]),
}


class ReverbEffect:
    """Schroeder reverb (sound.c:340-520): parallel damped comb filters
    (early reflections) summed, then cascaded allpass diffusers, mixed
    dry/wet. Stateful across process() calls like the reference's
    per-chain filter state."""

    def __init__(self, reverb_type: str = "small_room",
                 room_size: float = 1.0, damping: float = 0.2,
                 wet_dry: float = 0.3, channels: int = 1,
                 feedback: float = 0.84):
        if not (0.0 <= room_size <= 1.0 and 0.0 <= damping <= 1.0
                and 0.0 <= wet_dry <= 1.0):
            raise ValueError("reverb params out of [0,1]")
        comb_sizes, ap_sizes = _REVERB_TYPES[reverb_type]
        self.sizes = np.maximum(
            (np.array(comb_sizes) * room_size).astype(np.int64), 1)
        self.ap_sizes = np.maximum(
            (np.array(ap_sizes) * room_size).astype(np.int64), 1)
        nc, ch = len(comb_sizes), channels
        self.bufs = np.zeros((nc, int(self.sizes.max()), ch), np.float32)
        self.pos = np.zeros(nc, np.int64)
        self.fstore = np.zeros((nc, ch), np.float32)
        self.abufs = [np.zeros((int(s), ch), np.float32)
                      for s in self.ap_sizes]
        self.apos = np.zeros(len(ap_sizes), np.int64)
        self.feedback = feedback          # decay (sound.c:496 fixed 0.84)
        self.damp1 = damping
        self.damp2 = 1.0 - damping
        self.wet = wet_dry
        self.dry = 1.0 - wet_dry
        self.channels = ch

    def process(self, buf: np.ndarray) -> np.ndarray:
        """(frames,) or (frames, channels) float32 → same shape."""
        mono = buf.ndim == 1
        x = buf[:, None] if mono else buf
        out = np.empty_like(x, np.float32)
        nc = len(self.sizes)
        idx = np.arange(nc)
        for i in range(x.shape[0]):       # IIR recursions are sequential
            xi = x[i]
            outs = self.bufs[idx, self.pos]                  # (nc, ch)
            self.fstore = outs * self.damp2 + self.fstore * self.damp1
            self.bufs[idx, self.pos] = xi + self.fstore * self.feedback
            self.pos = (self.pos + 1) % self.sizes
            y = outs.mean(0)
            for a, ab in enumerate(self.abufs):
                buffered = ab[self.apos[a]]
                ab[self.apos[a]] = y + buffered * 0.5
                self.apos[a] = (self.apos[a] + 1) % self.ap_sizes[a]
                y = buffered - y
            out[i] = xi * self.dry + y * self.wet
        return out[:, 0] if mono else out


class DelayEffect:
    """Feedback delay line (sound.c:522-607): per-channel delay, the
    delayed signal feeds back into the ring, dry/wet mix. Vectorized in
    blocks of the shortest delay (within a block every read precedes the
    write that could alias it)."""

    MAX_SAMPLES = 96000   # 2 s at 48 kHz (sound.c:527)

    def __init__(self, delay_ms, feedback: float = 0.4,
                 wet_dry: float = 0.5, rate: int = SAMPLE_RATE,
                 channels: int = 1):
        if not (0.0 <= feedback <= 1.0 and 0.0 <= wet_dry <= 1.0):
            raise ValueError("delay params out of [0,1]")
        d = np.atleast_1d(np.asarray(delay_ms, np.float64))
        if d.shape[0] != channels:
            d = np.full((channels,), float(d[0]))
        if (d < 0).any():
            raise ValueError("negative delay")
        self.delay = np.maximum((d / 1000.0 * rate).astype(np.int64), 1)
        if int(self.delay.max()) > self.MAX_SAMPLES:
            raise ValueError("delay exceeds 2 s buffer")
        self.size = int(self.delay.max())
        self.buf = np.zeros((self.size, channels), np.float32)
        self.wpos = 0
        self.feedback = feedback
        self.wet = wet_dry
        self.dry = 1.0 - wet_dry
        self.channels = channels

    def process(self, buf: np.ndarray) -> np.ndarray:
        mono = buf.ndim == 1
        x = buf[:, None] if mono else buf
        out = np.empty_like(x, np.float32)
        step = int(self.delay.min())
        i = 0
        while i < x.shape[0]:
            n = min(step, x.shape[0] - i)
            w = (self.wpos + np.arange(n)) % self.size          # (n,)
            r = (w[:, None] + self.size - self.delay[None, :]) % self.size
            delayed = self.buf[r, np.arange(self.channels)[None, :]]
            xi = x[i:i + n]
            out[i:i + n] = xi * self.dry + delayed * self.wet
            self.buf[w] = xi + delayed * self.feedback
            self.wpos = int((self.wpos + n) % self.size)
            i += n
        return out[:, 0] if mono else out


def apply_effect_chain(chain, buf: np.ndarray) -> np.ndarray:
    """Run a buffer through an ordered effect list (the reference's
    sound_effect_chain node processes effects in list order,
    sound.c:286-300)."""
    for eff in chain or ():
        buf = eff.process(buf)
    return buf
