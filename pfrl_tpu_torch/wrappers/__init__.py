"""Host env wrappers (counterpart of ``pfrl_tpu/wrappers``): numpy in, numpy
out. So far the Atari preprocessing stack, :mod:`.atari_wrappers`."""
