"""Curriculum engine.

A copy of ``handwriting_line_generation_tpu/training/curriculum.py``: the
config maps a start iteration to a list of lessons; each lesson is a list of
tags with an optional int duplication prefix; within a stage, lessons
round-robin by ``iteration % len(lessons)``.  The paper GAN cycle is 7
lessons: ``count | no-step,gen | auto,auto-gen | disc | no-step,gen |
auto,auto-gen | disc``.  Stages resolve as a pure function of the
iteration, so the same iteration always maps to the same lesson.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


class Curriculum:
    def __init__(self, lesson_desc: Dict[str, List[List]]):
        stages: List[Tuple[int, List[List[str]]]] = []
        self.need_sep_gen_opt = False
        self.need_sep_style_ex_opt = False
        self.need_style_in_disc = False
        self.sample_disc = False
        valid, evals = set(), set()
        for start, lessons in (lesson_desc or {}).items():
            expanded: List[List[str]] = []
            for lesson in lessons:
                dup = 1
                tags: List[str] = []
                for a in lesson:
                    if isinstance(a, int):
                        dup = a
                        continue
                    tags.append(a)
                    if "auto-style" in a:
                        self.need_sep_gen_opt = True
                    if "style-ex-only" in a:
                        self.need_sep_style_ex_opt = True
                    if "style-super" in a:
                        self.need_style_in_disc = True
                    if "sample-disc" in a:
                        self.sample_disc = True
                    if ("gen" not in a and "disc" not in a
                            and a != "split-style" and "triplet" not in a):
                        valid.add(a)
                    if ("disc" not in a and a != "split-style"
                            and "triplet" not in a):
                        evals.add(a)
                expanded.extend([list(tags)] * dup)
            stages.append((int(start), expanded))
        stages.sort(key=lambda s: s[0])
        self.stages = stages
        self.valid_tags = sorted(valid) + ["valid"]
        self.eval_tags = sorted(evals) + ["eval"]

    def get_lesson(self, iteration: int) -> List[str]:
        """The lesson's tags; ``[]`` before the first stage starts."""
        active: List[List[str]] = []
        for start, lessons in self.stages:
            if iteration >= start:
                active = lessons
        if not active:
            return []
        return active[iteration % len(active)]

    def lesson_key(self, iteration: int) -> str:
        """The lesson's tags, sorted and joined: one key per step kind."""
        return "+".join(sorted(self.get_lesson(iteration)))

    def distinct_lessons(self) -> List[List[str]]:
        seen, out = set(), []
        for _, lessons in self.stages:
            for lesson in lessons:
                k = "+".join(sorted(lesson))
                if k not in seen:
                    seen.add(k)
                    out.append(lesson)
        return out
