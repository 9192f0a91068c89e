"""Online localization: stream audio blocks through StreamingLocalizer.

Simulates a microphone-array capture and feeds it block-by-block, as an
audio callback would — one jitted step per 64 ms hop.
"""

import jax
import numpy as np

from pyaudiolocalization_tpu.models.online import StreamingLocalizer
from pyaudiolocalization_tpu.models.simulator import simulate_signals
from pyaudiolocalization_tpu.models.acoustics import speed_of_sound

FS = 16000.0
MICS = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                 [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
C = float(speed_of_sound(20.0, 50.0))
SRC = [0.35, 0.55, 0.45]

capture = np.asarray(simulate_signals(SRC, MICS, FS, C, duration=1.0,
                                      signal_type="noise",
                                      key=jax.random.PRNGKey(0)))

loc = StreamingLocalizer(MICS, FS, C, lower=[0, 0, 0], upper=[1, 1, 1],
                         frame=4096, hop=1024, band=(300.0, 3400.0))
state = loc.init_state()
print(f"streaming {capture.shape[1] / FS:.1f}s of audio in "
      f"{int(1024 / FS * 1000)} ms hops; true source = {SRC}")
for i in range(capture.shape[1] // 1024):
    out = loc.step(state, capture[:, i * 1024:(i + 1) * 1024])
    state = out.state
    if i >= 4 and i % 3 == 0:  # past warmup, print occasionally
        p = np.asarray(out.position)
        err = np.linalg.norm(p - np.asarray(SRC))
        print(f"t={((i + 1) * 1024) / FS:5.2f}s  "
              f"pos=({p[0]:.3f},{p[1]:.3f},{p[2]:.3f})  err={err * 100:.1f} cm")
