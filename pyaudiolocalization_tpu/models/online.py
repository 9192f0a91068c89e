"""Online (streaming) localization: feed fixed-size sample blocks, get a
position per block — the serving-shaped API.

No reference counterpart (the reference is batch-only).  State is a ring
of the last ``frame`` samples per mic plus an exponential moving average —
of the whitened-able cross-power spectra (broadband ``method='srp'``):

    rfft(window * frame) -> cross-spectra -> EMA -> PHAT whiten ->
    irfft -> SRP-PHAT box search -> position

or of the full per-bin spatial covariance (narrowband
``method='capon'``/``'music'``, for tonal sources):

    rfft(window * frame) -> per-bin outer products -> EMA -> local-max
    bin selection -> MVDR / subspace map -> box search -> position

The EMA plays the role of the Welch average in ``gcc_phat_streaming`` (or
of the batch estimators' snapshot average) with O(1) state, so latency per
block is constant and independent of the stream length.  Wrap ``step`` in
``jax.jit`` once and drive it from the audio callback; everything is
functional (state in, state out), so it also vmaps across independent
streams.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import capon as capon_ops
from . import music as music_ops
from . import srp as srp_ops
from .srp import suppressed_multi_search, two_stage_search
from ..ops import gccphat


class StreamState(NamedTuple):
    buffer: jnp.ndarray      # (M, frame) most recent samples
    cross_r: jnp.ndarray     # (P, bins) EMA cross-spectrum, real plane
    cross_i: jnp.ndarray     # (P, bins) imag plane
    auto: jnp.ndarray        # (M, bins) EMA per-mic auto power spectra —
    # feeds the non-PHAT GCC weightings (scot/roth/ml); EMA'd with the
    # same constant so coherence estimates stay consistent
    count: jnp.ndarray       # () blocks absorbed (diagnostics; note that
    # EMA warmup debiasing (1 - a^count) would be a positive scalar on the
    # cross-spectra, which PHAT whitening cancels exactly — so none is
    # applied; the ratio weightings cancel it the same way)


class CovStreamState(NamedTuple):
    """State for the narrowband methods ('capon'/'music'): instead of
    per-pair cross-spectra, an EMA of the FULL per-bin spatial covariance
    at the COARSE analysis resolution ``nb_frame`` (all M x M mic products
    as real/imag planes, ~250 kB at M=8, nb_frame=256) — the snapshot
    average the batch estimators compute over STFT frames, maintained
    online with O(1) state, plus an EMA of the per-bin inter-frame
    phase-advance sums that drive the phase-vocoder frequency
    refinement."""
    buffer: jnp.ndarray      # (M, frame) most recent samples
    cov_r: jnp.ndarray       # (nb_bins, M, M) EMA covariance, real plane
    cov_i: jnp.ndarray       # (nb_bins, M, M) imag plane
    shift_r: jnp.ndarray     # (nb_bins,) EMA phase-advance sum, real plane
    shift_i: jnp.ndarray     # (nb_bins,) imag plane
    count: jnp.ndarray       # () blocks absorbed


class StreamOutput(NamedTuple):
    position: jnp.ndarray    # (3,), or (K, 3) for num_sources=K > 1
    power: jnp.ndarray       # () SRP confidence, or (K,)
    state: StreamState


class StreamingLocalizer:
    """Stateful online localizer.  ``frame`` must be a power of two and a
    multiple of ``hop``; positions are searched over the static box
    [lower, upper].

    ``method`` selects the estimator:
      * 'srp' (default) — broadband GCC-PHAT + SRP box search (EMA of the
        whitened-able cross-spectra);
      * 'capon' / 'music' — narrowband snapshot-covariance estimators for
        tonal sources (which have no usable correlation peaks): each hop,
        the current ``frame`` buffer is cut into overlapping COARSE
        ``nb_frame`` snapshots (exactly the batch estimators' STFT), their
        per-bin spatial covariances and inter-frame phase advances are
        EMA'd into the state, and the MVDR / subspace map is scanned over
        the box at the tempered top-``num_bins`` coarse bins with
        phase-vocoder-refined frequencies.  Coarse bins keep the batch
        APIs' cross-bin frequency diversity — a tone's Hann skirt spans
        several selected bins whose refined frequencies differ by a few
        Hz, which misalign at grating lobes but agree at the true source
        (an earlier fine-bin local-max design had no such diversity and
        put the second of two talkers at 600+850 Hz on a ~19 cm grating
        artifact; the intra-hop snapshots make the phase-vocoder
        refinement unambiguous at ANY hop, which the fine-bin design's
        one-FFT-per-hop state could not achieve).  There is no bin-weight
        floor: weak emitters participate exactly as in the batch APIs.

    Complex EMA state is kept as real/imag planes (pytrees of real planes
    jit cleanly).
    """

    def __init__(self, mic_positions, fs: float, c: float,
                 lower, upper, frame: int = 4096, hop: int = 1024,
                 ema: float = 0.7,
                 band: Optional[Tuple[float, float]] = None,
                 coarse_n: Optional[int] = None,
                 fine_n: Optional[int] = None,
                 num_sources: int = 1,
                 min_separation: Optional[float] = None,
                 method: str = "srp",
                 num_bins: int = 8,
                 loading: float = 1e-3,
                 nb_frame: int = 256,
                 weighting: str = "phat",
                 suppression: str = "spatial",
                 motion: str = "static",
                 motion_subframes: int = 8,
                 max_speed: float = 5.0):
        if frame & (frame - 1):
            raise ValueError("frame must be a power of two")
        if frame % hop:
            raise ValueError("frame must be a multiple of hop")
        if nb_frame & (nb_frame - 1) or not 0 < nb_frame <= frame:
            raise ValueError("nb_frame must be a power of two <= frame")
        if method not in ("srp", "capon", "music"):
            raise ValueError(
                "method must be 'srp' (broadband GCC-PHAT), 'capon', or "
                "'music' (narrowband covariance estimators)")
        if weighting not in gccphat.GCC_WEIGHTINGS:
            raise ValueError(f"unknown weighting {weighting!r}; expected "
                             f"one of {gccphat.GCC_WEIGHTINGS}")
        if weighting != "phat" and method != "srp":
            raise ValueError("weighting applies to the broadband 'srp' "
                             "method only (capon/music are covariance "
                             "estimators with no GCC stage)")
        # The EMA cross/auto spectra are exactly the Welch averages the
        # 'ml' (Hannan-Thomson) weighting needs — streaming is where its
        # coherence estimate is non-degenerate (ops/gccphat.GCC_WEIGHTINGS).
        self.weighting = weighting
        self.mics = jnp.asarray(np.asarray(mic_positions, np.float32))
        m = self.mics.shape[0]
        pi, pj = np.triu_indices(m, 1)
        self.pi = pi.astype(np.int32)
        self.pj = pj.astype(np.int32)
        self.fs = float(fs)
        self.c = float(c)
        self.lower = jnp.asarray(np.asarray(lower, np.float32))
        self.upper = jnp.asarray(np.asarray(upper, np.float32))
        self.frame = frame
        self.hop = hop
        self.ema = float(ema)
        self.band = band
        # Method-aware grid defaults: the MVDR/MUSIC peaks are much sharper
        # than SRP's, and a 20^3 coarse lattice undersamples them (measured
        # on the 1 m 8-mic cube at 600+1000 Hz: the suppression search's
        # second peak lands on a ~19 cm grating lobe at coarse_n=20 and on
        # the true talker at the batch estimators' 24^3/12^3 grids).
        narrow = method in ("capon", "music")
        self.coarse_n = coarse_n if coarse_n is not None else (24 if narrow
                                                               else 20)
        self.fine_n = fine_n if fine_n is not None else (12 if narrow else 10)
        coarse_n = self.coarse_n
        # num_sources > 1 localizes K simultaneous talkers per hop with
        # iterative-suppression SRP (models/srp.srp_phat_locate_multi);
        # outputs gain a leading K axis in coarse extraction order —
        # wrap with OnlineTracker (below) for identity-stable tracks
        # (momentum-gated K! assignment), or run the batch
        # models/tracking.track_multiple over a recorded capture.
        if num_sources < 1:
            raise ValueError("num_sources must be >= 1")
        if method == "music" and num_sources >= self.mics.shape[0]:
            raise ValueError("music needs num_sources < num_mics (noise "
                             "subspace must be non-empty)")
        if suppression not in ("spatial", "claim"):
            raise ValueError("suppression must be 'spatial' or 'claim'")
        if motion not in ("static", "compensated"):
            raise ValueError("motion must be 'static' or 'compensated'")
        if motion == "compensated" and method != "srp":
            raise ValueError("motion='compensated' requires method='srp'")
        if motion == "compensated" and weighting == "ml":
            raise ValueError("motion='compensated' uses single-snapshot "
                             "subframe GCCs — 'ml' needs Welch-averaged "
                             "coherence")
        self.num_sources = num_sources
        self.min_separation = min_separation
        # Multi-source broadband extraction mode: 'claim' nulls each
        # extracted source's per-pair lags before the next search (kills
        # the mixed-pair SRP ghosts that outbid a weaker talker on sparse
        # arrays — see srp_phat_locate_multi); the narrowband methods
        # have their own bin claiming (_claimed_multi_search).
        self.suppression = suppression
        self.method = method
        self.num_bins = int(num_bins)
        self.loading = float(loading)
        self.nb_frame = int(nb_frame)
        self.nb_hop = self.nb_frame // 2
        self.pool = srp_ops._resolve_pool(None, self.lower, self.upper,
                                          coarse_n, self.fs, self.c)
        n_ = np.arange(frame)
        self._window = jnp.asarray(
            (0.5 - 0.5 * np.cos(2 * np.pi * n_ / frame)).astype(np.float32))
        if band is not None:
            freqs = np.fft.rfftfreq(frame, d=1.0 / fs)
            self._mask = jnp.asarray(
                ((freqs >= band[0]) & (freqs <= band[1])).astype(np.float32))
            nb_freqs = np.fft.rfftfreq(self.nb_frame, d=1.0 / fs)
            self._mask_nb = jnp.asarray(
                ((nb_freqs >= band[0])
                 & (nb_freqs <= band[1])).astype(np.float32))
        else:
            self._mask = None
            self._mask_nb = None
        self.motion = motion
        if motion == "compensated":
            # Per-hop rate matched-filter-bank detection on the CURRENT
            # frame (models/tracking._detect_rate_envelope): the EMA'd
            # cross-spectra smear a mover across hops on top of the
            # intra-frame drift, so compensated mode detects on the live
            # frame's subframe GCCs instead.  Sizing mirrors
            # track_multiple's (host-side, concrete mics).
            lf = frame // motion_subframes
            if lf < 64:
                raise ValueError("frame // motion_subframes must be >= 64")
            mics_np = np.asarray(mic_positions, float)
            diam = float(np.max(np.linalg.norm(
                mics_np[:, None, :] - mics_np[None, :, :], axis=-1)))
            self._mc_nsub = int(motion_subframes)
            self._mc_nfft = int(2 ** int(np.ceil(np.log2(2 * lf))))
            self._mc_whalf = int(np.ceil(diam * float(fs) / float(c))) + 12
            self._mc_smax = int(np.ceil(2.0 * float(max_speed) / float(c)
                                        * frame / 2.0)) + 2
            wn = self._mc_whalf + self._mc_smax
            self._mc_wlen = 2 * wn + 1
            if self._mc_wlen > self._mc_nfft:
                raise ValueError(
                    "motion='compensated' alignment window (mic diameter "
                    f"{self._mc_whalf} + drift margin {self._mc_smax} "
                    f"lags) exceeds the subframe transform "
                    f"{self._mc_nfft}: use a longer frame, fewer "
                    "motion_subframes, or a smaller max_speed")
            self._mc_npad = int(2 ** int(np.ceil(np.log2(self._mc_wlen))))
            self._mc_dtf = jnp.asarray(
                ((np.arange(motion_subframes) + 0.5) * lf
                 - (motion_subframes * lf) / 2.0).astype(np.float32))
            self._band = band
        self._step = jax.jit(self._step_impl)
        self._run = jax.jit(self._run_impl)

    def init_state(self):
        m = self.mics.shape[0]
        p = self.pi.shape[0]
        bins = self.frame // 2 + 1
        if self.method != "srp":
            nb_bins = self.nb_frame // 2 + 1
            return CovStreamState(
                buffer=jnp.zeros((m, self.frame), jnp.float32),
                cov_r=jnp.zeros((nb_bins, m, m), jnp.float32),
                cov_i=jnp.zeros((nb_bins, m, m), jnp.float32),
                shift_r=jnp.zeros((nb_bins,), jnp.float32),
                shift_i=jnp.zeros((nb_bins,), jnp.float32),
                count=jnp.zeros((), jnp.int32))
        return StreamState(
            buffer=jnp.zeros((m, self.frame), jnp.float32),
            cross_r=jnp.zeros((p, bins), jnp.float32),
            cross_i=jnp.zeros((p, bins), jnp.float32),
            auto=jnp.zeros((m, bins), jnp.float32),
            count=jnp.zeros((), jnp.int32))

    def _step_cov_impl(self, state: CovStreamState,
                       block: jnp.ndarray) -> StreamOutput:
        """Narrowband step: cut the buffer into overlapping ``nb_frame``
        snapshots (the batch estimators' STFT, models/music.snapshot_frames
        semantics), EMA the per-bin covariances and phase-advance sums,
        then scan the Capon/MUSIC map at the tempered top-``num_bins``
        coarse bins with phase-vocoder-refined frequencies.

        Why COARSE intra-hop snapshots instead of one fine FFT per hop:
        coarse bins keep the cross-bin frequency DIVERSITY that vetoes
        grating lobes (a tone's skirt bins refine to slightly different
        frequencies — grating lobes misalign across them, the true source
        aligns), and the intra-hop frame pairs make the phase-advance
        estimator unambiguous regardless of the stream hop (the previous
        fine-bin design had one FFT per hop, so refinement aliased at
        hop >= frame/4 and selection had to fall back to local maxima —
        no diversity, ~19 cm grating artifacts on the second talker at
        600+850 Hz, and a ~25 dB bin-weight floor to keep noise local
        maxima out; all three limits are gone here)."""
        m = self.mics.shape[0]
        buf = jnp.concatenate([state.buffer[:, self.hop:], block], axis=1)
        snaps = music_ops.snapshot_frames(buf, self.nb_frame, self.nb_hop)
        xr = jnp.real(snaps).astype(jnp.float32)            # (M, F, K)
        xi = jnp.imag(snaps).astype(jnp.float32)
        f_cnt = xr.shape[1]
        # Per-bin snapshot covariances (1/F) X X^H as real/imag planes.
        out_r = (jnp.einsum("mfk,nfk->kmn", xr, xr)
                 + jnp.einsum("mfk,nfk->kmn", xi, xi)) / f_cnt
        out_i = (jnp.einsum("mfk,nfk->kmn", xi, xr)
                 - jnp.einsum("mfk,nfk->kmn", xr, xi)) / f_cnt
        # Per-bin inter-frame phase-advance sums (refine_bin_freqs'
        # statistic), accumulated across mics and intra-hop frame pairs.
        pr = (xr[:, 1:, :] * xr[:, :-1, :]
              + xi[:, 1:, :] * xi[:, :-1, :])
        pi_ = (xi[:, 1:, :] * xr[:, :-1, :]
               - xr[:, 1:, :] * xi[:, :-1, :])
        adv_r = jnp.sum(pr, axis=(0, 1))                    # (K,)
        adv_i = jnp.sum(pi_, axis=(0, 1))
        a = self.ema
        cvr = a * state.cov_r + (1.0 - a) * out_r
        cvi = a * state.cov_i + (1.0 - a) * out_i
        shr = a * state.shift_r + (1.0 - a) * adv_r
        shi = a * state.shift_i + (1.0 - a) * adv_i
        new_state = CovStreamState(buf, cvr, cvi, shr, shi, state.count + 1)

        # Bin selection from the EMA auto power: the UNION of the batch
        # APIs' tempered top-``num_bins`` (close tones, skirt diversity)
        # and per-LOCAL-MAXIMUM peak groups (peak bin +- 1 skirt for the
        # top ``num_bins // 3`` maxima).  Plain top-k alone starves weak
        # emitters of bins entirely — a 30 dB-stronger talker's Hann skirt
        # occupies every top-k slot (measured: the weak talker lands on a
        # ~19 cm grating artifact, batch APIs included) — while the peak
        # groups guarantee every distinct emitter representation.
        power = jnp.einsum("kmm->k", cvr)                   # (K,)
        if self._mask_nb is not None:
            power = power * self._mask_nb
        nb_bins = power.shape[0]
        power = power.at[0].set(0.0).at[-1].set(0.0)
        npeaks = max(1, self.num_bins // 3)
        is_peak = ((power >= jnp.roll(power, 1))
                   & (power > jnp.roll(power, -1)))
        # DC/Nyquist excluded: the roll test wraps them against each other.
        is_peak = is_peak.at[0].set(False).at[-1].set(False)
        pvals, pidx = jax.lax.top_k(jnp.where(is_peak, power, 0.0), npeaks)
        kvals, kidx = jax.lax.top_k(power, self.num_bins)
        skirt = jnp.clip((pidx[:, None]
                          + jnp.array([-1, 0, 1], pidx.dtype)).reshape(-1),
                         1, nb_bins - 2)                    # (3*npeaks,)
        idx = jnp.concatenate([kidx, skirt])
        vals = power[idx]
        # Noise-floor gate (never relative to the strongest peak — that
        # would be the old weak-emitter floor): a LOW in-band quantile
        # estimates the noise floor, and a genuine emitter sits several
        # times above it while a noise local maximum hugs it (the EMA'd,
        # frame- and mic-averaged per-bin power has tiny relative
        # variance).  The 12.5th percentile, not the median: with a
        # narrow analysis band the strong tone's Hann-skirt pedestal
        # contaminates half the in-band bins (measured: a -30 dB emitter
        # at only 1.85x the in-band MEDIAN but ~10x the low quantile),
        # while the low quantile still tolerates a freak null bin that a
        # strict min would not.  Top-k entries are gated on their OWN
        # power (the per-bin peak normalization below would otherwise
        # amplify a noise bin's random structure to unit height); skirt
        # entries are gated on their PEAK's power, so a weak emitter
        # keeps its whole group.
        if self._mask_nb is not None:
            n_inband = int(np.count_nonzero(np.asarray(self._mask_nb)))
            floor_src = jnp.where(self._mask_nb > 0, power, jnp.inf)
        else:
            n_inband = nb_bins
            floor_src = power
        noise_floor = 6.0 * jnp.sort(floor_src)[max(1, n_inband // 8)]
        valid = jnp.concatenate([kvals > noise_floor,
                                 jnp.repeat(pvals > noise_floor, 3)])
        tempered = jnp.where(valid, jnp.maximum(vals, 0.0) ** 0.3, 0.0)
        # The top-k/skirt union overlaps (a strong peak's bins appear in
        # both): zero every duplicate copy but the best-gated one, or the
        # doubled weight biases the summed map toward the strong emitter
        # (static-shape dedup: scatter-max per bin + first-position tie
        # break).
        pos = jnp.arange(idx.shape[0])
        seg_max = jnp.zeros(nb_bins, tempered.dtype).at[idx].max(tempered)
        at_max = tempered >= seg_max[idx]
        first = jnp.full(nb_bins, idx.shape[0]).at[idx].min(
            jnp.where(at_max, pos, idx.shape[0]))
        tempered = jnp.where(at_max & (pos == first[idx]), tempered, 0.0)
        bin_w = tempered / jnp.maximum(jnp.sum(tempered), 1e-30)

        # Phase-vocoder frequency refinement from the EMA'd advance sums
        # (models/music.refine_bin_freqs with hop = nb_hop = nb_frame/2,
        # always unambiguous), clamped to +-0.55 bin.
        base = (2.0 * jnp.pi * idx.astype(jnp.float32) / self.nb_frame)
        adv = jnp.arctan2(shi[idx], shr[idx])
        two_pi = 2.0 * jnp.pi
        delta = (adv - base * self.nb_hop + jnp.pi) % two_pi - jnp.pi
        half_bin = 0.55 * two_pi / self.nb_frame
        delta = jnp.clip(delta / self.nb_hop, -half_bin, half_bin)
        omega = (base + delta) * self.fs

        emb = music_ops.embed_planes(cvr[idx], cvi[idx])    # (B, 2M, 2M)
        if self.method == "capon":
            inv = capon_ops.loaded_inverse(emb, self.loading)

            def bins_fn(p_):
                return capon_ops.capon_map_bins(inv, omega, p_, self.mics,
                                                self.c)
        else:  # music
            # Batch semantics: protect a num_sources-dimensional signal
            # subspace per bin (the EMA over many well-conditioned
            # intra-hop snapshot covariances supports it — the old
            # rank-one-per-fine-bin special case is gone with the
            # fine-bin selection).
            _, vecs = jnp.linalg.eigh(emb)
            subs = vecs[:, :, :2 * m - 2 * self.num_sources]

            def bins_fn(p_):
                return music_ops.music_map_bins(subs, omega, p_, self.mics,
                                                self.c)

        def map_fn(p_):
            return jnp.sum(bin_w[None, :] * bins_fn(p_), axis=-1)

        if self.num_sources > 1:
            positions, powers = self._claimed_multi_search(bins_fn, bin_w)
            return StreamOutput(positions, powers, new_state)
        pos, pw, _, _ = two_stage_search(map_fn, map_fn, self.lower,
                                         self.upper, self.coarse_n,
                                         self.fine_n, jnp.float32)
        return StreamOutput(jnp.clip(pos, self.lower, self.upper), pw,
                            new_state)

    def _claimed_multi_search(self, bins_fn, bin_w):
        """Multi-source extraction by iterative argmax + spatial
        suppression + BIN CLAIMING: after each extracted source, the bins
        whose own per-bin lattice argmax it explains are zeroed for the
        later rounds, so round k+1 searches only the bins of the remaining
        emitters.  This is what lets a 30 dB-weaker talker win round 2:
        the per-bin map scale spans orders of magnitude with bin SNR (MVDR
        scales with in-bin source power, MUSIC sharpness with subspace
        resolution), so on the SUMMED map the strong talker's secondary
        structure — grating lobes included — outbids the weak talker's
        genuine peak (measured: 0.28 vs 0.20 at a ~19 cm grating point);
        on the weak talker's OWN bins its true peak wins by ~27x.  When a
        round claims every remaining bin (fewer emitters than
        num_sources), later rounds keep the previous weights and rely on
        the spatial suppression alone (the old behavior)."""
        dtype = jnp.float32
        pts = srp_ops._grid_points(self.lower, self.upper, self.coarse_n,
                                   dtype)
        per = bins_fn(pts)                                  # (G, B)
        bin_arg = pts[jnp.argmax(per, axis=0)]              # (B, 3)
        cell = (self.upper - self.lower) / self.coarse_n
        radius = (3.0 * jnp.max(cell) if self.min_separation is None
                  else jnp.asarray(self.min_separation, dtype))

        def pick(carry, _):
            w, sup = carry
            vals = jnp.sum(w[None, :] * per, axis=-1) + sup
            center = pts[jnp.argmax(vals)]
            claimed = (jnp.linalg.norm(bin_arg - center[None, :], axis=-1)
                       <= radius)
            w_next = jnp.where(claimed, 0.0, w)
            w_next = jnp.where(jnp.sum(w_next) > 1e-30, w_next, w)
            sup = jnp.where(
                jnp.linalg.norm(pts - center[None, :], axis=-1) <= radius,
                -jnp.inf, sup)
            return (w_next, sup), (center, w)

        _, (centers, round_w) = jax.lax.scan(
            pick, (bin_w, jnp.zeros(pts.shape[0], dtype)), None,
            length=self.num_sources)

        def refine_one(center, w):
            fine_pts = srp_ops._grid_points(center - 1.5 * cell,
                                            center + 1.5 * cell,
                                            self.fine_n, dtype)
            fine_val = jnp.sum(w[None, :] * bins_fn(fine_pts), axis=-1)
            k = jnp.argmax(fine_val)
            pos = fine_pts[k] + srp_ops.quadratic_peak_offset(
                fine_val, k, self.fine_n, 3.0 * cell / self.fine_n)
            return pos, fine_val[k]

        positions, powers = jax.vmap(refine_one)(centers, round_w)
        return (jnp.clip(positions, self.lower[None, :],
                         self.upper[None, :]), powers)

    def _step_impl(self, state, block: jnp.ndarray) -> StreamOutput:
        if self.method != "srp":
            return self._step_cov_impl(state, block)
        buf = jnp.concatenate([state.buffer[:, self.hop:], block], axis=1)
        spec = jnp.fft.rfft(buf * self._window[None, :], n=self.frame)
        cross = jnp.take(spec, self.pi, 0) * jnp.conj(jnp.take(spec, self.pj, 0))
        a = self.ema
        cr = a * state.cross_r + (1.0 - a) * jnp.real(cross)
        ci = a * state.cross_i + (1.0 - a) * jnp.imag(cross)
        if self.weighting in ("phat", "cc"):
            # These weightings never consult the per-mic auto spectra —
            # carry the state through unchanged (the EMA update and the
            # downstream takes DCE away) instead of paying (M, bins)
            # elementwise work per step on the hot path.
            auto = state.auto
        else:
            auto = a * state.auto + (1.0 - a) * (jnp.real(spec) ** 2
                                                 + jnp.imag(spec) ** 2)
        # Reuse the shared weighting (gccphat._weight_cross / PHAT_EPS) so
        # the streaming path cannot drift from the batch pipeline's
        # semantics; the EMA spectra are the Welch averages the ratio
        # weightings (scot/roth/ml) expect.
        white = gccphat._weight_cross(
            jax.lax.complex(cr, ci),
            jnp.take(auto, self.pi, 0), jnp.take(auto, self.pj, 0),
            self.weighting, gccphat.PHAT_EPS)
        if self._mask is not None:
            white = white * self._mask
        new_state = StreamState(buf, cr, ci, auto, state.count + 1)
        if self.motion == "compensated":
            from . import tracking as tracking_ops
            pi_t = tuple(self.pi.tolist())
            pj_t = tuple(self.pj.tolist())
            wn = self._mc_whalf + self._mc_smax
            win = tracking_ops._subframe_windows(
                buf[None], pi_t, pj_t, self.fs, self._band, self.weighting,
                self._mc_nsub, wn, self._mc_nfft)
            spec_w = jnp.fft.rfft(win, n=self._mc_npad, axis=-1)
            dets, powers = tracking_ops._detect_rate_envelope(
                spec_w, self.mics, pi_t, pj_t, self.fs, self.c,
                self.lower, self.upper, self.num_sources, self._mc_dtf,
                self._mc_npad, self._mc_wlen, self._mc_whalf,
                self._mc_smax, self._mc_nfft, self.coarse_n, self.fine_n,
                None)
            if self.num_sources > 1:
                return StreamOutput(dets[0], powers[0], new_state)
            return StreamOutput(dets[0, 0], powers[0, 0], new_state)
        corr = jnp.fft.irfft(white, n=self.frame)
        if self.num_sources > 1:
            multi = srp_ops.srp_phat_locate_multi(
                corr, self.mics, self.pi, self.pj, self.fs, self.c,
                self.lower, self.upper, num_sources=self.num_sources,
                coarse_n=self.coarse_n, fine_n=self.fine_n,
                min_separation=self.min_separation, pool_samples=self.pool,
                suppression=self.suppression)
            return StreamOutput(multi.positions, multi.powers, new_state)
        out = srp_ops.srp_phat_locate(
            corr, self.mics, self.pi, self.pj, self.fs, self.c,
            self.lower, self.upper, coarse_n=self.coarse_n,
            fine_n=self.fine_n, pool_samples=self.pool)
        return StreamOutput(out.position, out.power, new_state)

    def step(self, state: StreamState, block) -> StreamOutput:
        """Absorb one (M, hop) block and localize.  Jitted; O(1) state."""
        block = jnp.asarray(block, jnp.float32)
        if block.shape != (self.mics.shape[0], self.hop):
            raise ValueError(
                f"block must be (num_mics, hop) = "
                f"({self.mics.shape[0]}, {self.hop}), got {block.shape}")
        return self._step(state, block)

    def _run_impl(self, state: StreamState, blocks: jnp.ndarray):
        def scan_step(st, block):
            out = self._step_impl(st, block)
            return out.state, (out.position, out.power)
        _, (positions, powers) = jax.lax.scan(scan_step, state, blocks)
        return positions, powers

    def run(self, signals) -> Tuple[np.ndarray, np.ndarray]:
        """Convenience: stream a whole (M, T) capture through the step
        update under ONE ``lax.scan`` (one host→device upload, one
        dispatch, one fetch — driving ``step`` per hop from the host pays
        an upload and a dispatch per block); returns
        (positions (S, 3), powers (S,)) for the S full hops after the
        first full frame (with ``num_sources=K``: (S, K, 3), (S, K)).
        Recompiles per distinct hop count; real-time callers drive
        ``step`` directly."""
        signals = np.asarray(signals, np.float32)
        m, t = signals.shape
        num_blocks = t // self.hop
        warmup = self.frame // self.hop
        if num_blocks < warmup:  # capture shorter than one frame
            shape = ((0, 3) if self.num_sources == 1
                     else (0, self.num_sources, 3))
            pshape = (0,) if self.num_sources == 1 else (0, self.num_sources)
            return np.zeros(shape, np.float32), np.zeros(pshape, np.float32)
        blocks = jnp.asarray(
            signals[:, :num_blocks * self.hop]
            .reshape(m, num_blocks, self.hop)
            .transpose(1, 0, 2))                       # (S_all, M, hop)
        positions, powers = self._run(self.init_state(), blocks)
        return (np.asarray(positions[warmup - 1:]),
                np.asarray(powers[warmup - 1:]))


class TrackedOutput(NamedTuple):
    positions: jnp.ndarray    # (K, 3) identity-stable track positions
    powers: jnp.ndarray       # (K,) detection powers, track order
    associated: jnp.ndarray   # (K,) bool — detection passed the gate
    velocities: jnp.ndarray   # (K, 3) alpha-beta velocity estimates (m/s)
    state: tuple


class OnlineTracker:
    """Causal identity maintenance over a multi-talker StreamingLocalizer.

    ``StreamingLocalizer(num_sources=K)`` emits per-hop fixes in
    EXTRACTION (power) order, which flips between hops; this wrapper
    applies the same momentum-gated exact K! assignment as the batch
    ``models/tracking.track_multiple`` (``tracking.association_step``)
    one hop at a time — O(1) state, fully causal, jittable via the
    wrapped localizer's jitted step.  Crossing movers keep their
    identities by MOMENTUM (each track predicts forward with its
    alpha-beta velocity before assignment); detections farther than
    ``gate`` meters from every prediction leave their track coasting.

    During the localizer's warm-up (the first frame//hop hops, while the
    EMA state is still filling) tracks re-initialize from the raw
    detections each hop instead of updating — otherwise a garbage first
    fix would strand the tracks outside the gate forever.
    """

    def __init__(self, localizer: StreamingLocalizer,
                 gate: Optional[float] = None,
                 max_speed: float = 5.0):
        if localizer.num_sources < 2:
            raise ValueError("OnlineTracker needs a multi-talker localizer "
                             "(num_sources >= 2)")
        if localizer.num_sources > 5:
            raise ValueError("association enumerates K! assignments; "
                             "num_sources > 5 is unsupported")
        from . import tracking as tracking_ops
        self._assoc = tracking_ops.association_step
        self.loc = localizer
        self.dt = localizer.hop / localizer.fs
        self.gate = (max_speed * self.dt + 0.3) if gate is None else float(gate)
        self.warmup = localizer.frame // localizer.hop

    def init_state(self):
        k = self.loc.num_sources
        return (self.loc.init_state(),
                jnp.zeros((k, 3), jnp.float32),
                jnp.zeros((k, 3), jnp.float32),
                jnp.asarray(0, jnp.int32))

    def step(self, state, block) -> TrackedOutput:
        """Absorb one (M, hop) block; localize + associate."""
        loc_state, pos, vel, n = state
        out = self.loc.step(loc_state, block)
        det = out.position
        pw = out.power
        warm = n >= self.warmup
        pos_eff = jnp.where(warm, pos, det)
        vel_eff = jnp.where(warm, vel, jnp.zeros_like(vel))
        (pos_new, vel_new), (z, zp, ok) = self._assoc(
            pos_eff, vel_eff, det, pw, self.dt, self.gate)
        # Emit the raw (reordered) detection when it passed the gate, the
        # coasting prediction otherwise — a gated-out detection is by
        # definition a wild fix (ghost / dropout) and emitting it raw
        # hands the consumer a ~1 m outlier with only a False flag to
        # catch it.
        ok_eff = ok & warm
        pred = pos_eff + vel_eff * self.dt
        emit = jnp.where(ok_eff[:, None], z, pred)
        return TrackedOutput(emit, zp, ok_eff, vel_new,
                             (out.state, pos_new, vel_new, n + 1))

    def run(self, signals) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Stream a whole (M, T) capture; returns (positions (S, K, 3),
        powers (S, K), associated (S, K)) for the S full hops after the
        first full frame (identity-stable K axis)."""
        signals = np.asarray(signals, np.float32)
        m, t = signals.shape
        hop = self.loc.hop
        num_blocks = t // hop
        k = self.loc.num_sources
        if num_blocks < self.warmup:
            return (np.zeros((0, k, 3), np.float32),
                    np.zeros((0, k), np.float32), np.zeros((0, k), bool))
        state = self.init_state()
        ps, ws, oks = [], [], []
        blocks = signals[:, :num_blocks * hop].reshape(m, num_blocks, hop)
        for s in range(num_blocks):
            outt = self.step(state, jnp.asarray(blocks[:, s]))
            state = outt.state
            if s >= self.warmup - 1:
                ps.append(np.asarray(outt.positions))
                ws.append(np.asarray(outt.powers))
                oks.append(np.asarray(outt.associated))
        return np.stack(ps), np.stack(ws), np.stack(oks)
